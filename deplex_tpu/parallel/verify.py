"""Distributed bring-up verification worker.

Runs one process of a jax.distributed group (launched by
`deplex_tpu.parallel.launcher` locally, or one-per-host on a pod), executes
the framework's two distributed paths end-to-end —

  1. frame extraction sharded over the global 'data' mesh (the
     embarrassingly-parallel path: no collectives, data placement only), and
  2. one keyframe-sharded BA step (`slam.ba.ba_step(axis_name=...)`) whose
     Schur reduction rides psum/all_gather across processes (NCCL on
     hardware, gloo in CPU simulation)

— and writes this process's results to `--out/proc<id>.npz` so a supervisor
(tests/test_multiprocess.py, or an operator checking a new slice) can assert
cross-process agreement with the single-process result.

The reference has no distributed capability to mirror (SURVEY.md §2.4);
this is the new multi-host axis of BASELINE.json's north star.

Usage (2-process CPU simulation of an 8-device slice):

    python -m deplex_tpu.parallel.launcher --nprocs 2 --local-devices 4 \
        --platform cpu -- python -m deplex_tpu.parallel.verify --out /tmp/v
"""

from __future__ import annotations

import argparse
import os
import pathlib

import numpy as np

# Deterministic tiny workload shared by workers and the supervising test.
VERIFY_H, VERIFY_W = 48, 64
VERIFY_BA_LANDMARKS = 10


def verify_config():
    from deplex_tpu.config import Config

    return Config(max_planes=8, max_region_growing_rounds=16)


def synth_depth(batch: int, height: int = VERIFY_H, width: int = VERIFY_W):
    """(B, H, W) uint16 synthetic depth: two tilted wall planes per frame,
    frame-indexed offsets so every frame is distinct but reproducible."""
    u = np.arange(width, dtype=np.float32)[None, :]
    v = np.arange(height, dtype=np.float32)[:, None]
    frames = []
    for b in range(batch):
        left = 1200.0 + 40.0 * b + 3.0 * u + 1.5 * v
        right = 2400.0 + 25.0 * b + 1.0 * u + 4.0 * v
        z = np.where(u < width // 2, left, right)
        frames.append(z)
    return np.stack(frames).astype(np.uint16)


def synth_intrinsics(height: int = VERIFY_H, width: int = VERIFY_W):
    return np.array([[525.0, 0.0, width / 2 - 0.5],
                     [0.0, 525.0, height / 2 - 0.5],
                     [0.0, 0.0, 1.0]], np.float32)


def synth_ba_problem(num_keyframes: int, num_landmarks: int = VERIFY_BA_LANDMARKS):
    """Deterministic plane-BA problem (numpy arrays; perturbed ground truth)."""
    import jax
    import jax.numpy as jnp

    from deplex_tpu.slam.ba import BAProblem
    from deplex_tpu.slam.lie import se3_exp, so3_exp
    from deplex_tpu.slam.planes import to_cp, transform_plane

    rng = np.random.default_rng(1234)
    n_w = rng.normal(size=(num_landmarks, 3)).astype(np.float32)
    n_w /= np.linalg.norm(n_w, axis=1, keepdims=True)
    d_w = rng.uniform(500, 3000, size=num_landmarks).astype(np.float32)
    R_true = np.asarray(so3_exp(jnp.asarray(
        rng.normal(size=(num_keyframes, 3)).astype(np.float32) * 0.1)))
    t_true = (rng.normal(size=(num_keyframes, 3)) * 50).astype(np.float32)
    n_c, d_c = jax.vmap(transform_plane, in_axes=(0, 0, None, None))(
        jnp.asarray(R_true), jnp.asarray(t_true),
        jnp.asarray(n_w), jnp.asarray(d_w))
    # Perturb poses (except 0, the gauge) so the GN step moves.
    xi = rng.normal(size=(num_keyframes, 6)).astype(np.float32) * \
        np.array([0.02, 0.02, 0.02, 10.0, 10.0, 10.0], np.float32)
    xi[0] = 0.0
    dR, dt = se3_exp(jnp.asarray(xi))
    R0 = np.asarray(dR @ jnp.asarray(R_true))
    t0 = np.asarray(jnp.einsum("kij,kj->ki", dR, jnp.asarray(t_true)) + dt)
    obs_lm = np.broadcast_to(np.arange(num_landmarks, dtype=np.int32),
                             (num_keyframes, num_landmarks)).copy()
    return BAProblem(
        R=R0, t=t0, eta=np.asarray(to_cp(jnp.asarray(n_w), jnp.asarray(d_w))),
        obs_normal=np.asarray(n_c), obs_d=np.asarray(d_c), obs_lm=obs_lm,
        obs_w=np.ones((num_keyframes, num_landmarks), np.float32))


def _gather_local(arr):
    """(global_indices, values) of this process's addressable leading-axis
    shards of a 'data'-sharded global array."""
    idx, vals = [], []
    for s in arr.addressable_shards:
        sl = s.index[0]
        start = 0 if sl.start is None else sl.start
        data = np.asarray(s.data)
        idx.append(np.arange(start, start + data.shape[0]))
        vals.append(data)
    order = np.argsort(np.concatenate(idx))
    return np.concatenate(idx)[order], np.concatenate(vals)[order]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--frames-per-device", type=int, default=1)
    args = ap.parse_args(argv)

    # The platform knob must win over any site-registered plugin, and must be
    # set before the backend initializes (conftest.py has the same note).
    import jax

    if os.environ.get("JAX_PLATFORMS"):
        jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

    from deplex_tpu.parallel.distributed import initialize, make_mesh

    initialize()

    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    nproc = jax.process_count()
    pid = jax.process_index()
    if os.environ.get("JAX_NUM_PROCESSES"):
        assert nproc == int(os.environ["JAX_NUM_PROCESSES"]), \
            f"process_count {nproc} != requested {os.environ['JAX_NUM_PROCESSES']}"
    ndev = jax.device_count()
    mesh = make_mesh("data")

    # --- 1. extraction sharded over the global mesh --------------------
    from deplex_tpu.parallel.batch import extract_depth_batch

    cfg = verify_config()
    B = args.frames_per_device * ndev
    sharding = NamedSharding(mesh, P("data", None, None))
    # Every process can synthesize any frame; it contributes only its local
    # rows (this is the host-local input pipeline pattern: no global gather).
    local_rows = sorted(
        {0 if s[0].start is None else s[0].start
         for d, s in sharding.devices_indices_map((B, VERIFY_H, VERIFY_W)).items()
         if d.process_index == pid})
    all_frames = synth_depth(B)
    local = np.stack([all_frames[int(r)] for r in local_rows])
    depth = jax.make_array_from_process_local_data(sharding, local, (B, VERIFY_H, VERIFY_W))
    K = jnp.asarray(synth_intrinsics())

    # Under shard_map each device extracts its own frames (XLA cannot
    # partition the GPU growing kernel's custom call).
    labels = jax.jit(jax.shard_map(
        lambda d, k: extract_depth_batch(d, k, cfg), mesh=mesh,
        in_specs=(P("data", None, None), P()), out_specs=P("data", None),
        check_vma=False))(depth, K)
    jax.block_until_ready(labels)
    frame_idx, labels_local = _gather_local(labels)

    # --- 2. keyframe-sharded BA step (psum/all_gather across processes) --
    from deplex_tpu.slam.ba import BAProblem, BAState, ba_step

    prob_np = synth_ba_problem(num_keyframes=ndev)
    kf_shard = {f: NamedSharding(mesh, P("data") if f != "eta" else P())
                for f in BAProblem._fields}

    def put(field, value):
        sh = kf_shard[field]
        if field == "eta":
            return jax.make_array_from_process_local_data(sh, value, value.shape)
        local_kf = sorted(
            {0 if s[0].start is None else s[0].start
             for d, s in sh.devices_indices_map(value.shape).items()
             if d.process_index == pid})
        lv = np.stack([value[int(r)] for r in local_kf])
        return jax.make_array_from_process_local_data(sh, lv, value.shape)

    # Optional prior fields (odo_*/cv_w) are None here; np.asarray(None)
    # is a 0-d object array and a P("data") spec on a 0-d value is an
    # error — pass None through (None leaves match None in_specs).
    prob = BAProblem(**{
        f: (None if getattr(prob_np, f) is None
            else put(f, np.asarray(getattr(prob_np, f))))
        for f in BAProblem._fields})

    def step(p):
        st = ba_step(p, damping=1e-4, axis_name="data")
        return BAState(
            R=jax.lax.all_gather(st.R, "data", axis=0, tiled=True),
            t=jax.lax.all_gather(st.t, "data", axis=0, tiled=True),
            eta=st.eta, cost=st.cost)

    sharded_ba = jax.jit(jax.shard_map(
        step, mesh=mesh,
        in_specs=(BAProblem(R=P("data"), t=P("data"), eta=P(),
                            obs_normal=P("data"), obs_d=P("data"),
                            obs_lm=P("data"), obs_w=P("data")),),
        out_specs=BAState(R=P(), t=P(), eta=P(), cost=P()),
        check_vma=False))
    state = sharded_ba(prob)
    jax.block_until_ready(state)

    # --- 3. PRODUCT path: the full keyframe-sharded LM loop across the
    # process boundary (slam.ba.run_ba_sharded — what PlaneSlam.refine()
    # runs on a multi-device runtime). Inputs are already placed on the
    # global mesh; outputs stay keyframe-sharded, so each process records
    # its local shards for the supervisor to reassemble.
    from deplex_tpu.slam.ba import run_ba_sharded

    lm_state = run_ba_sharded(prob, mesh, axis="data", iterations=4)
    jax.block_until_ready(lm_state)
    lm_idx, lm_R_local = _gather_local(lm_state.R)
    _, lm_t_local = _gather_local(lm_state.t)

    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    np.savez(out / f"proc{pid}.npz",
             process_count=nproc, device_count=ndev,
             frame_idx=frame_idx, labels=labels_local,
             ba_R=np.asarray(state.R), ba_t=np.asarray(state.t),
             ba_eta=np.asarray(state.eta), ba_cost=np.asarray(state.cost),
             lm_kf_idx=lm_idx, lm_R=lm_R_local, lm_t=lm_t_local,
             lm_eta=np.asarray(lm_state.eta),
             lm_cost=np.asarray(lm_state.cost))
    print(f"verify proc {pid}/{nproc}: devices={ndev} frames={list(frame_idx)} "
          f"ba_cost={float(state.cost):.6f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
