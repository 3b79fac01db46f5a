"""The port's ``prof_layout`` and ``probe_bf16`` tools
(``cfd2_tpu_torch/tools/``) against the JAX package's same computations
(``tools/prof_layout.py``, ``tools/probe_bf16.py``: their operations
written out here with ``jax.numpy`` on the port's seeded inputs) on the
CPU, on (12, 20) planes.  These tools count no iterations: what is held is
what each timed operation computes.

Tolerances: float32 results within 1e-5 relative (the JAX package's
products are contracted by XLA, the port's plain ones are not); the bf16
forms within 2e-2 relative (their rounding to bf16 differs by an ulp of
bf16 where the two libraries round intermediate products apart).  Times are
not compared."""

import numpy as np
import torch

import jax
import jax.numpy as jnp
from jax import lax

from cfd2_tpu_torch.tools import probe_bf16, prof_layout

torch.set_num_threads(2)
quiet = lambda m: None
NY, NX = 12, 20


def _close(got, ref, rtol):
    got = np.asarray(got.float().numpy() if torch.is_tensor(got) else got,
                     np.float64)
    ref = np.asarray(jnp.asarray(ref, jnp.float32), np.float64)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rtol * max(1.0, np.abs(ref).max())


def _shifts2(xg):
    """tools/probe_bf16.py:22-27."""
    e = jnp.concatenate([xg[..., 1:], xg[..., -1:]], axis=-1)
    w = jnp.concatenate([xg[..., :1], xg[..., :-1]], axis=-1)
    n = jnp.concatenate([xg[..., 1:, :], xg[..., -1:, :]], axis=-2)
    s = jnp.concatenate([xg[..., :1, :], xg[..., :-1, :]], axis=-2)
    return e, w, n, s


def _dot4(o, sh):
    return o[0] * sh[0] + o[1] * sh[1] + o[2] * sh[2] + o[3] * sh[3]


def test_prof_layout_computes_the_jax_tools_operations():
    got = prof_layout.run(NY, NX, "cpu", log=quiet)
    ops = prof_layout.inputs(NY, NX, "cpu")
    D, ch = 3 * NY * NX, prof_layout.CH
    xp, xf, Vf, Vp, d, x3 = (jnp.asarray(ops[k].numpy()) for k in
                             ("xp", "xf", "Vf", "Vp", "d", "x3"))
    e, w, n, s = _shifts2(xp)
    ref = {   # tools/prof_layout.py:53-107
        "reshape_p2f": xp.reshape(D) + 1.0,
        "reshape_f2p": xf.reshape(3, NY, NX) + 1.0,
        "to_planar": x3.T.reshape(3, NY, NX),
        "from_planar_copy": xp.reshape(3, -1).T,
        "add_flat": xf + 1.0,
        "cgs_flat": Vf[:ch] @ xf,
        "cgs_tiled": jnp.sum(Vp[:ch] * xp[None], axis=(1, 2, 3)),
        "proj_flat": d @ Vf[:ch],
        "proj_tiled": jnp.sum(d[:, None, None, None] * Vp[:ch], axis=0),
        "rowupd_flat": xf,
        "stencil_pl": xp * 2.0 - 0.5 * (e + w + n + s),
    }
    for name, r in ref.items():
        _close(got[name][1], r, 1e-5)
    e, w, n, s = _shifts2(xf.reshape(3, NY, NX))
    _close(got["stencil_flat"][1],
           (xf.reshape(3, NY, NX) * 2.0 - 0.5 * (e + w + n + s)).reshape(D),
           1e-5)
    assert list(got)[0] == "launch" and all(
        row["wall_ms"] > 0 and row["device_ms"] is None
        for row, _ in got.values())


def test_probe_bf16_computes_the_jax_tools_loops():
    got = probe_bf16.run(NY, NX, "cpu", log=quiet)
    a = {k: jnp.asarray(v.numpy())
         for k, v in probe_bf16.inputs(NY, NX, "cpu").items()}

    def mom_loop(di, of, ru, rv):   # tools/probe_bf16.py:32-53
        def mom_solve(ru):
            z_u, z_v = di * ru, di * rv
            for _ in range(7):
                z_u = di * (ru - _dot4(of, _shifts2(z_u)))
                z_v = di * (rv - _dot4(of, _shifts2(z_v)))
            return z_u, z_v
        return lax.fori_loop(0, 20, lambda k, c: mom_solve(ru + c[0] * 1e-30),
                             (ru, rv))

    def cgs(Vb, wv):                # :59-66
        def body(k, wc):
            dd = jnp.sum(Vb * wc[None], axis=(1, 2, 3))
            return wc - jnp.sum(dd[:, None, None, None] * Vb, axis=0) * 1e-30
        return lax.fori_loop(0, 20, body, wv)

    def smooth(Po, di, rr):         # :74-77
        return lax.fori_loop(0, 20, lambda k, x: di * (
            rr - _dot4(Po, _shifts2(x))), rr)

    bf = lambda t: t.astype(jnp.bfloat16)
    r_u, r_v = a["r"][0], a["r"][1]
    for tag, tol in (("f32", 1e-5), ("bf16", 2e-2)):
        c = (lambda t: t) if tag == "f32" else bf
        zu, zv = jax.jit(mom_loop)(c(a["dinv"]), c(a["off"]), c(r_u), c(r_v))
        _close(got[f"momentum m8 {tag}"][1], jnp.stack([zu, zv]), tol)
        _close(got[f"pressure sweep {tag}"][1],
               jax.jit(smooth)(c(a["P"]), c(a["dinv"]), c(r_u)), tol)
    _close(got["CGS 24-row f32"][1], jax.jit(cgs)(a["V"], a["w"]), 1e-5)
    _close(got["CGS 24-row bf16V"][1], jax.jit(cgs)(bf(a["V"]), a["w"]), 1e-5)
