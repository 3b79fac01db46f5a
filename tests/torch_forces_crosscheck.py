"""Cd/Cl of a state exported by ``chip_smoke.py --export-forces PATH``, read
by the JAX package's ``cfd2_tpu/utils/forces.py`` on a CPU.

    JAX_PLATFORMS=cpu python tests/torch_forces_crosscheck.py PATH

The export holds the obstacle mask's four face tensors in full and the wall
faces with their owner cells' geometry and fields, so the JAX functions run
on it without building the mesh: ``obstacle_face_mask`` on the four face
tensors, ``force_coefficients`` on the wall faces (the only faces a mask
can select, so the sum is the full one).  Printed: the JAX mask against the
port's, the JAX Cd/Cl against the port's (limit 1e-4 of the larger, as
``chip_smoke.py`` phase 11(c) holds the card to float64), and the drag split
into the owner pressure, its extrapolation with grad_p and the viscous term,
with the faces that carry most of it.  Exits 1 when the packages disagree.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np


def jax_reading(path, u_ref: float = 1.0, d_ref: float = 0.4) -> dict:
    """The JAX package's mask and (Cd, Cl) on an export, with the port's
    and the drag's parts (each as Cd)."""
    import jax.numpy as jnp
    from cfd2_tpu.utils import forces as jf

    with np.load(path) as d:
        e = {k: d[k] for k in d.files}
    faces = SimpleNamespace(**{k: jnp.asarray(e[k]) for k in
                               ("f_boundary", "f_cx", "f_cy", "f_area")})
    mask = np.asarray(jf.obstacle_face_mask(faces))
    wall = e["wall"]
    assert not mask[np.setdiff1d(np.arange(len(mask)), wall)].any()
    dm = SimpleNamespace(
        f_owner=jnp.asarray(e["wall_owner"]), f_nx=jnp.asarray(e["wall_nx"]),
        f_ny=jnp.asarray(e["wall_ny"]), f_area=faces.f_area[wall],
        f_cx=faces.f_cx[wall], f_cy=faces.f_cy[wall],
        c_cx=jnp.asarray(e["c_cx"]), c_cy=jnp.asarray(e["c_cy"]))
    state = SimpleNamespace(u=jnp.asarray(e["u"]), p=jnp.asarray(e["p"]),
                            grad_p=jnp.asarray(e["grad_p"]))
    params = SimpleNamespace(viscosity=jnp.asarray(e["viscosity"]),
                             density=jnp.asarray(e["density"]))
    w = mask[wall]
    cd, cl = jf.force_coefficients(dm, state, params, w, u_ref=u_ref,
                                   d_ref=d_ref)

    # The drag's parts, in float64 from the same arrays.
    q = 0.5 * float(e["density"]) * u_ref ** 2 * d_ref
    sel = wall[w > 0]
    own = e["wall_owner"][w > 0]
    nx, ny = e["wall_nx"][w > 0], e["wall_ny"][w > 0]
    A = e["f_area"][sel].astype(np.float64)
    dx = e["f_cx"][sel] - e["c_cx"][own].astype(np.float64)
    dy = e["f_cy"][sel] - e["c_cy"][own].astype(np.float64)
    gp = e["grad_p"][own].astype(np.float64)
    u = e["u"][own].astype(np.float64)
    un = u[:, 0] * nx + u[:, 1] * ny
    d = np.maximum(np.abs(dx * nx + dy * ny), 1e-12)
    parts = {"owner p": e["p"][own] * nx * A,
             "grad_p extrapolation": (gp[:, 0] * dx + gp[:, 1] * dy) * nx * A,
             "viscous": float(e["viscosity"]) * (u[:, 0] - un * nx) / d * A}
    per_face = sum(parts.values()) / q
    # The streamwise pressure gradient and velocity of the cells along the
    # bottom channel wall (wall faces at the domain's lowest y).
    fy = e["f_cy"][wall]
    bot = (e["wall_ny"] < -0.99) & (fy < fy.min() + 1e-6)
    bx = e["c_cx"][e["wall_owner"][bot]].astype(np.float64)
    bp = e["p"][e["wall_owner"][bot]].astype(np.float64)
    bu = e["u"][e["wall_owner"][bot], 0].astype(np.float64)
    vol = e["c_vol"][own] / np.median(e["c_vol"])
    top = np.argsort(-np.abs(per_face))[:5]
    return {
        "mask_equal": np.array_equal(np.flatnonzero(mask),
                                     e["port_mask_faces"]),
        "faces": int(mask.sum()), "jax": (float(cd), float(cl)),
        "port": tuple(float(v) for v in e["port_cd_cl"]),
        "parts": {k: float(v.sum() / q) for k, v in parts.items()},
        "top": [(int(sel[i]), float(per_face[i]), float(vol[i]),
                 float(np.hypot(*gp[i])), float(d[i])) for i in top],
        "median_vol": float(np.median(e["c_vol"])),
        "bottom_wall": {"cells": int(bot.sum()),
                        "dp_dx": float(np.polyfit(bx, bp, 1)[0]),
                        "p_first_last": (float(bp[np.argmin(bx)]),
                                         float(bp[np.argmax(bx)])),
                        "mean_u": float(bu.mean())},
        "obstacle_p": (float(e["p"][own][np.argmin(e["f_cx"][sel])]),
                       float(e["p"][own][np.argmax(e["f_cx"][sel])])),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", help="the .npz written by chip_smoke.py "
                    "--export-forces")
    r = jax_reading(ap.parse_args(argv).path)
    (jcd, jcl), (pcd, pcl) = r["jax"], r["port"]
    err = max(abs(jcd - pcd), abs(jcl - pcl))
    limit = 1e-4 * max(abs(jcd), abs(jcl))
    print(f"obstacle faces {r['faces']}; JAX mask equal to the port's: "
          f"{r['mask_equal']}")
    print(f"JAX Cd {jcd:.7f} Cl {jcl:+.7f}; port (card) Cd {pcd:.7f} "
          f"Cl {pcl:+.7f}; max|diff| {err:.3e} (limit {limit:.3e})")
    print("drag parts (as Cd): " + ", ".join(
        f"{k} {v:+.4f}" for k, v in r["parts"].items()))
    print(f"largest faces (median wall-cell volume {r['median_vol']:.3e}): "
          "face, Cd share, owner volume / median, |grad_p|, wall distance")
    for row in r["top"]:
        print("  %d %+.4f %.3e %.4g %.3e" % row)
    b = r["bottom_wall"]
    print(f"owner pressure at the obstacle's upstream / downstream face "
          f"{r['obstacle_p'][0]:.4f} / {r['obstacle_p'][1]:.4f}")
    p0, p1 = b["p_first_last"]
    print(f"bottom-wall cells ({b['cells']}): p from {p0:.4f} to {p1:.4f}, "
          f"least-squares dp/dx "
          f"{b['dp_dx']:+.4f}, mean u_x {b['mean_u']:+.4f}")
    return 0 if r["mask_equal"] and err <= limit else 1


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    sys.exit(main())
