"""Real multi-process distributed execution: worker body + subprocess launcher.

The reference's one parallelism strategy actually executes every frame inside
a single process (reference: source/Renderer.cpp:42-85).  This module is the
cross-process analog that actually executes: every worker process calls
``multihost.initialize`` (jax.distributed; Gloo on CPU, NCCL on GPUs),
builds the global ``pod_mesh``, renders a pixel+primitive-sharded frame and
runs one psum'd sharded train step.  Two mesh layouts execute: the default
pod layout (px across processes — the gradient psum and image gather cross
processes) and a transposed layout whose prim axis spans the processes, so
the closest-hit winner-merge all-gather crosses the process boundary too.

Two entry modes:

  worker:    python -m raytpu.parallel.launch --process-id I --num-processes N
             --coordinator HOST:PORT --outdir DIR
  launcher:  python -m raytpu.parallel.launch --spawn N --outdir DIR
             (spawns N workers as subprocesses on this host and waits; used by
             tests/test_multihost_2proc.py)

On a real cluster every host runs the worker mode under its own scheduler; the
``--spawn`` launcher exists so a single dev box can execute the genuine
multi-controller path (2+ OS processes, cross-process Gloo collectives) rather
than only a virtual single-process mesh.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np


def _globalize(tree, mesh, spec=None):
    """Replicate a host-local pytree of arrays onto the global mesh.

    Every process must call this with identical data (SPMD).  Leaves become
    jax.Arrays spanning all processes' devices with sharding ``spec``
    (default fully-replicated), so they are valid inputs to jitted
    computations over a multi-process mesh.
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(mesh, spec if spec is not None else P())

    def leaf(x):
        x = np.asarray(x)
        return jax.make_array_from_callback(x.shape, sharding, lambda idx: x[idx])

    return jax.tree_util.tree_map(leaf, tree)


def _fetch_replicated(x, mesh):
    """All-gather a global array to replicated and return it as host numpy."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    rep = jax.jit(lambda v: v, out_shardings=NamedSharding(mesh, P()))(x)
    return np.asarray(rep.addressable_data(0))


def run_worker(process_id: int, num_processes: int, coordinator: str, outdir: str,
               local_devices: int = 2, size=(64, 48), train_size=(32, 24)) -> dict:
    """The SPMD worker body: init the multi-controller runtime, then execute
    a sharded render and one sharded train step across all processes."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", local_devices)

    from raytpu.parallel import multihost

    multihost.initialize(coordinator, num_processes=num_processes,
                         process_id=process_id)
    assert jax.process_count() == num_processes, jax.process_count()
    n_global = jax.device_count()
    assert n_global == num_processes * local_devices, n_global

    import jax.numpy as jnp
    import optax

    from raytpu.core import scenes
    from raytpu.core.types import RenderConfig
    from raytpu.grad import diff_render
    from raytpu.parallel.sharding import render_image_sharded
    from raytpu.parallel.training import make_sharded_train_step
    from raytpu.render import render_image

    # prim axis within-process, px across processes (multihost.pod_mesh layout)
    mesh = multihost.pod_mesh(prim=local_devices)
    assert mesh.shape == {"px": num_processes, "prim": local_devices}

    scene_local = scenes.get("reference").build()
    cfg = RenderConfig(width=size[0], height=size[1])

    # ---- sharded render across processes (px spans processes) -----------
    scene_g = _globalize(scene_local, mesh)
    t0 = time.perf_counter()
    img_g = render_image_sharded(scene_g, cfg, mesh, sweep=False)
    img = _fetch_replicated(img_g, mesh)
    render_s = time.perf_counter() - t0

    # single-process reference (local devices only) for bit-identity
    ref = np.asarray(render_image(scene_local, cfg))
    render_identical = bool((img == ref).all())

    # ---- prim-SPANNING-processes mesh: the closest-hit winner-merge
    # all_gather itself crosses the process boundary (pod_mesh's default
    # layout keeps prim within-host, so exercise the transposed layout too)
    from jax.sharding import Mesh

    devs = np.asarray(jax.devices()).reshape(num_processes, local_devices)
    mesh_x = Mesh(devs.T.copy(), axis_names=("px", "prim"))
    img_x = _fetch_replicated(
        render_image_sharded(_globalize(scene_local, mesh_x), cfg, mesh_x,
                             sweep=False), mesh_x)
    render_xprim_identical = bool((img_x == ref).all())

    # ---- one psum'd sharded train step across processes -----------------
    tcfg = RenderConfig(width=train_size[0], height=train_size[1])
    target_local = jnp.zeros((tcfg.height, tcfg.width, 3), jnp.float32)
    opt = optax.sgd(1e-2)
    params_local = diff_render.material_params(scene_local)
    opt_state_local = opt.init(params_local)

    step = make_sharded_train_step(
        tcfg, opt, diff_render.material_params,
        diff_render.merge_material_params, mesh)
    t0 = time.perf_counter()
    p_g, _, loss_g = step(_globalize(params_local, mesh),
                          _globalize(opt_state_local, mesh),
                          scene_g, _globalize(target_local, mesh))
    loss = float(_fetch_replicated(loss_g, mesh))
    params_out = jax.tree_util.tree_map(lambda v: _fetch_replicated(v, mesh), p_g)
    step_s = time.perf_counter() - t0

    # single-device reference step
    step1 = diff_render.make_train_step(
        tcfg, opt, diff_render.material_params, diff_render.merge_material_params)
    p1, _, loss1 = step1(jax.tree_util.tree_map(jnp.copy, params_local),
                         opt.init(params_local), scene_local, target_local)

    result = {
        "process_id": process_id,
        "process_count": jax.process_count(),
        "global_devices": n_global,
        "mesh": dict(mesh.shape),
        "render_identical_to_single_process": render_identical,
        "render_xprim_identical_to_single_process": render_xprim_identical,
        "loss_sharded": loss,
        "loss_single": float(loss1),
        "render_wall_s": round(render_s, 3),
        "train_step_wall_s": round(step_s, 3),
    }
    params_close = all(
        np.allclose(np.asarray(a), b, rtol=1e-4, atol=1e-6)
        for a, b in zip(jax.tree_util.tree_leaves(p1),
                        jax.tree_util.tree_leaves(params_out))
    )
    result["params_match_single_process"] = bool(params_close)
    result["loss_match"] = bool(np.isclose(loss, float(loss1), rtol=1e-5))

    if outdir:
        np.save(os.path.join(outdir, f"img_p{process_id}.npy"), img)
        with open(os.path.join(outdir, f"result_p{process_id}.json"), "w") as f:
            json.dump(result, f)
    return result


def spawn(num_processes: int, outdir: str, port: int = 0, timeout: float = 600.0,
          local_devices: int = 2) -> list:
    """Launch ``num_processes`` worker subprocesses on this host and wait.

    Returns the per-process result dicts (raises on any worker failure)."""
    import socket

    if port == 0:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    os.makedirs(outdir, exist_ok=True)
    procs = []
    logs = []
    for pid in range(num_processes):
        cmd = [sys.executable, "-m", "raytpu.parallel.launch",
               "--process-id", str(pid), "--num-processes", str(num_processes),
               "--coordinator", coord, "--outdir", outdir,
               "--local-devices", str(local_devices)]
        # log to a file, not a pipe: a chatty worker must never block on a
        # full pipe buffer while its siblings wait in a collective
        log_path = os.path.join(outdir, f"worker_p{pid}.log")
        logs.append(log_path)
        with open(log_path, "w") as log_f:
            procs.append(subprocess.Popen(cmd, stdout=log_f,
                                          stderr=subprocess.STDOUT, text=True))
    # poll ALL workers: a worker crashing at startup must surface its own
    # traceback immediately, not read as a timeout of a sibling stuck in the
    # coordination barrier waiting for it
    deadline = time.time() + timeout
    while True:
        done = [p.poll() for p in procs]
        for pid, rc in enumerate(done):
            if rc is not None and rc != 0:
                for q in procs:
                    q.kill()
                with open(logs[pid]) as f:
                    tail = "\n".join(f.read().strip().splitlines()[-15:])
                raise RuntimeError(f"worker {pid} failed (rc={rc}):\n{tail}")
        if all(rc == 0 for rc in done):
            break
        if time.time() > deadline:
            for q in procs:
                q.kill()
            stuck = [i for i, rc in enumerate(done) if rc is None]
            raise RuntimeError(f"workers {stuck} timed out after {timeout}s "
                               f"(logs: {logs})")
        time.sleep(0.2)
    results = []
    for pid in range(num_processes):
        with open(os.path.join(outdir, f"result_p{pid}.json")) as f:
            results.append(json.load(f))
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--num-processes", type=int, default=2)
    p.add_argument("--coordinator", default=None)
    p.add_argument("--outdir", default="")
    p.add_argument("--local-devices", type=int, default=2)
    p.add_argument("--spawn", type=int, default=0,
                   help="launcher mode: spawn N workers on this host and wait")
    p.add_argument("--timeout", type=float, default=600.0)
    args = p.parse_args(argv)

    if args.spawn:
        results = spawn(args.spawn, args.outdir or tempfile.mkdtemp(prefix="raytpu_2proc"),
                        timeout=args.timeout, local_devices=args.local_devices)
        print(json.dumps(results, indent=1))
        ok = all(r["render_identical_to_single_process"]
                 and r["render_xprim_identical_to_single_process"]
                 and r["loss_match"]
                 and r["params_match_single_process"] for r in results)
        return 0 if ok else 1

    result = run_worker(args.process_id, args.num_processes, args.coordinator,
                        args.outdir, local_devices=args.local_devices)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
