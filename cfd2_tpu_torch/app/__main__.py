"""CLI entry: run a case headless and write field snapshots / animation.

Port of ``python -m cfd2_tpu.app`` with the same flags, plus ``--device``
(default ``cuda``: with no GPU it raises; ``--device cpu`` runs the plain
PyTorch path) and ``--log-every`` (the step lines' period).  The
command-line equivalent of the reference's egui application (src/main.rs +
ui/app.rs): pick geometry, mesh type/size, fluid preset,
scheme/preconditioner, run with adaptive dt, and render colormapped frames.

    python -m cfd2_tpu_torch.app --geometry channel --cell-size 0.02 \\
        --fluid Water --steps 200 --snapshot-every 20 --out frames

With ``--profile`` each printed step line adds its FGMRES iterations, wall
time and host reads, and the run ends with the hand-written kernels' launch
counts, the host reads, and the profiling report.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

from ..runtime import host_reads


def _layout(dm) -> str:
    if dm.structured:
        ny, nx = dm.grid_shape
        return f"structured {ny}x{nx}"
    if dm.multilevel:
        return "multilevel " + "+".join(f"{ny}x{nx}" for ny, nx in
                                        dm.ml_levels)
    return "generic (banded)" if dm.banded else "generic (block-ELL)"


def _launches() -> dict:
    """The hand-written kernels' launch counts (counted on CUDA only)."""
    from ..ops import banded_kernels as bk
    from ..ops import stencil_kernels as sk
    return {**sk.LAUNCHES, **bk.LAUNCHES}


def _final_state(solver) -> str:
    """One line on the last state: time, max|u|, max|p| and whether every
    field is finite (one host read)."""
    import torch
    st = solver.state
    fields = (st.u, st.p, st.d_p, st.grad_p, st.fluxes)
    vals = torch.stack([
        st.time, torch.linalg.vector_norm(st.u, dim=1).max(),
        st.p.abs().max(),
        torch.stack([torch.isfinite(f).all() for f in fields]).all().float()])
    t, umax, pmax, finite = host_reads.read(vals).tolist()
    return (f"final state: t={t:.6f} max|u|={umax:.6f} max|p|={pmax:.6f} "
            f"finite={bool(finite)}")


def main(argv=None):
    ap = argparse.ArgumentParser(description="cfd2_tpu_torch headless app")
    ap.add_argument("--geometry", default="channel",
                    choices=["channel", "backstep", "rect"])
    ap.add_argument("--mesh-type", default="cutcell",
                    choices=["cutcell", "delaunay", "voronoi"])
    ap.add_argument("--cell-size", type=float, default=0.02)
    ap.add_argument("--max-cell-size", type=float, default=0.0,
                    help="> cell-size enables local quadtree refinement "
                         "(cutcell only)")
    ap.add_argument("--fluid", default="Custom")
    ap.add_argument("--inlet-velocity", type=float, default=1.0)
    ap.add_argument("--scheme", type=int, default=0,
                    help="0=Upwind 1=SOU 2=QUICK")
    ap.add_argument("--time-scheme", type=int, default=0,
                    help="0=Euler 1=BDF2")
    ap.add_argument("--precond", type=int, default=0, help="0=Jacobi 1=AMG")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--field", default="mag",
                    choices=["mag", "u", "v", "p", "d_p"])
    ap.add_argument("--snapshot-every", type=int, default=0)
    ap.add_argument("--out",
                    default=os.path.join(tempfile.gettempdir(),
                                         "cfd2_frames"))
    ap.add_argument("--html", default="",
                    help="write an interactive HTML viewer of the snapshots")
    ap.add_argument("--forces", action="store_true",
                    help="print Cd/Cl on the immersed obstacle each "
                         "verbose step")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--scan", action="store_true",
                    help="run the multi-step loop with the CFL controller "
                         "on the device (no snapshots)")
    ap.add_argument("--live", action="store_true",
                    help="serve a live web viewer while the solver runs")
    ap.add_argument("--port", type=int, default=8787)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--log-every", type=int, default=10,
                    help="print every N-th step")
    args = ap.parse_args(argv)

    from ..app.driver import Simulation
    from ..app.fluids import Fluid
    from ..viz import FieldRenderer

    sim = Simulation(
        geometry=args.geometry, mesh_type=args.mesh_type,
        cell_size=args.cell_size, max_cell_size=args.max_cell_size,
        fluid=Fluid.by_name(args.fluid),
        inlet_velocity=args.inlet_velocity, scheme=args.scheme,
        time_scheme=args.time_scheme, precond=args.precond,
        device=args.device)
    print(f"mesh: {sim.mesh.num_cells} cells ({args.mesh_type}), "
          f"Re={sim.reynolds:.0f}")
    print(f"device: {sim.solver.device}, layout: {_layout(sim.solver.mesh)} "
          f"({sim.solver.mesh.num_cells} device cells)", flush=True)

    if args.profile:
        sim.profiling.enable()
    launches0, reads0 = _launches(), host_reads.COUNT["reads"]

    if args.live:
        from ..viz.live_server import LiveServer
        server = LiveServer(sim, port=args.port,
                            max_steps=args.steps).start()
        print(f"live viewer at {server.url}  (Ctrl-C to stop)")
        server.serve_until_done()
        return

    if args.scan:
        metrics = sim.run_scanned(args.steps)
        print(f"ran {args.steps} scanned steps; "
              f"final t={metrics['time'][-1]:.4f}, "
              f"max_vel={metrics['max_vel'][-1]:.3f}")
        forces = sim.force_coefficients() if args.forces else None
        if forces:
            print(f"final Cd={forces[0]:.3f} Cl={forces[1]:+.3f}")
    else:
        # Built only when frames are asked for: its fan triangulation is a
        # host loop over every cell.
        renderer = FieldRenderer(sim.mesh) if args.snapshot_every else None
        if renderer is not None:
            os.makedirs(args.out, exist_ok=True)
        frame_paths = []

        def snap(i, solver):
            path = os.path.join(args.out, f"frame_{i:05d}.png")
            renderer.render(
                type("S", (), {
                    "u": solver.mesh.to_host_order(solver.state.u),
                    "p": solver.mesh.to_host_order(solver.state.p),
                    "d_p": solver.mesh.to_host_order(solver.state.d_p)})(),
                mode=args.field, path=path)
            frame_paths.append((f"step {i}  t={float(solver.state.time):.4f}",
                                path))

        sim.run(args.steps, snapshot_every=args.snapshot_every,
                on_snapshot=snap if args.snapshot_every else None,
                verbose=True, show_forces=args.forces,
                log_every=args.log_every)
        if args.snapshot_every:
            print(f"frames in {args.out}")
        if args.html and frame_paths:
            from ..viz import write_html_viewer
            frames = []
            for label, p in frame_paths:
                with open(p, "rb") as f:
                    frames.append((label, f.read()))
            write_html_viewer(args.html, frames,
                              title=f"{args.geometry} / {args.fluid} / "
                                    f"{args.field}",
                              metadata={"cells": sim.mesh.num_cells,
                                        "Re": round(sim.reynolds, 1),
                                        "scheme": args.scheme,
                                        "mesh": args.mesh_type})
            print(f"viewer: {args.html}")

    if args.profile:
        launches = {k: v - launches0[k] for k, v in _launches().items()}
        print(f"kernel launches: {json.dumps(launches)}")
        print(f"host reads: {host_reads.COUNT['reads'] - reads0}")
        print(_final_state(sim.solver))
        print(sim.profiling.report())


if __name__ == "__main__":
    main()
