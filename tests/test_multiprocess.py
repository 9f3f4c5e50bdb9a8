"""Real 2-process jax.distributed execution (CPU simulation of 2 hosts).

The reference is single-process (SURVEY.md §2.4); this covers the new
multi-host axis end-to-end: parallel.launcher spawns 2 OS processes, each
with 4 fake CPU devices, parallel.distributed.initialize() wires the
coordinator, and the workers run

  * extraction sharded over the GLOBAL 8-device mesh (data placement only),
  * one keyframe-sharded ba_step whose psum/all_gather reductions cross the
    process boundary over gloo (standing in for NCCL),

then the test asserts both against the single-process result computed on
this process's own 8-device mesh.
"""

import pathlib
import sys

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


@pytest.mark.slow
def test_two_process_agreement(tmp_path):
    from deplex_tpu.parallel.launcher import launch
    from deplex_tpu.parallel.verify import (VERIFY_H, VERIFY_W, synth_ba_problem,
                                            synth_depth, synth_intrinsics,
                                            verify_config)

    results = launch(
        [sys.executable, "-m", "deplex_tpu.parallel.verify",
         "--out", str(tmp_path)],
        num_processes=2, local_devices=4, platform="cpu", timeout=900)
    assert len(results) == 2

    outs = [np.load(tmp_path / f"proc{i}.npz") for i in range(2)]
    for o in outs:
        assert int(o["process_count"]) == 2
        assert int(o["device_count"]) == 8

    # --- extraction: reassemble the globally-sharded labels ------------
    frame_idx = np.concatenate([o["frame_idx"] for o in outs])
    labels_mp = np.concatenate([o["labels"] for o in outs])
    order = np.argsort(frame_idx)
    assert sorted(frame_idx.tolist()) == list(range(8))  # disjoint cover
    labels_mp = labels_mp[order]

    import jax
    import jax.numpy as jnp

    from deplex_tpu.parallel.batch import extract_depth_batch

    cfg = verify_config()
    depth = jnp.asarray(synth_depth(8, VERIFY_H, VERIFY_W))
    K = jnp.asarray(synth_intrinsics(VERIFY_H, VERIFY_W))
    labels_sp = np.asarray(
        jax.jit(lambda d, k: extract_depth_batch(d, k, cfg))(depth, K))
    # No collectives on the extraction path: per-frame math is identical, so
    # the 2-process labels must match the single-process ones exactly.
    np.testing.assert_array_equal(labels_mp, labels_sp)
    assert labels_sp.max() > 0  # the synthetic walls are found

    # --- BA: dense single-process step vs cross-process Schur reduction --
    from deplex_tpu.slam.ba import BAProblem, ba_step

    prob = BAProblem(*(None if f is None else jnp.asarray(np.asarray(f))
                       for f in synth_ba_problem(8)))
    dense = ba_step(prob, damping=1e-4)
    for o in outs:
        # gloo all-reduce order differs from the dense reduction order;
        # agreement is to GN-step accuracy, not bitwise.
        np.testing.assert_allclose(o["ba_R"], np.asarray(dense.R), atol=1e-4)
        np.testing.assert_allclose(o["ba_t"], np.asarray(dense.t),
                                   rtol=5e-3, atol=0.2)
        np.testing.assert_allclose(o["ba_eta"], np.asarray(dense.eta),
                                   rtol=5e-3, atol=0.2)
        np.testing.assert_allclose(o["ba_cost"], np.asarray(dense.cost),
                                   rtol=1e-3, atol=1e-4)
    # Both processes computed identical replicated results.
    np.testing.assert_array_equal(outs[0]["ba_R"], outs[1]["ba_R"])
    np.testing.assert_array_equal(outs[0]["ba_eta"], outs[1]["ba_eta"])

    # --- PRODUCT path: full LM loop (run_ba_sharded) across processes ---
    from deplex_tpu.slam.ba import run_ba

    dense_lm = run_ba(prob, iterations=4)
    lm_idx = np.concatenate([o["lm_kf_idx"] for o in outs])
    lm_R = np.concatenate([o["lm_R"] for o in outs])
    lm_t = np.concatenate([o["lm_t"] for o in outs])
    order = np.argsort(lm_idx)
    assert sorted(lm_idx.tolist()) == list(range(8))  # disjoint kf cover
    np.testing.assert_allclose(lm_R[order], np.asarray(dense_lm.R),
                               atol=1e-4)
    np.testing.assert_allclose(lm_t[order], np.asarray(dense_lm.t),
                               rtol=5e-3, atol=0.2)
    for o in outs:
        np.testing.assert_allclose(o["lm_eta"], np.asarray(dense_lm.eta),
                                   rtol=5e-3, atol=0.2)
        np.testing.assert_allclose(o["lm_cost"], np.asarray(dense_lm.cost),
                                   rtol=1e-2, atol=1e-4)
    np.testing.assert_array_equal(outs[0]["lm_eta"], outs[1]["lm_eta"])


def test_launcher_rejects_failures(tmp_path):
    from deplex_tpu.parallel.launcher import launch

    script = tmp_path / "boom.py"
    script.write_text("import sys; sys.exit(3)\n")
    with pytest.raises(RuntimeError, match="failed"):
        launch([str(script)], num_processes=2, timeout=120)


def test_initialize_noop_without_coordinator(monkeypatch):
    """Single-process initialize() stays a no-op (same launcher script from
    1 to N hosts)."""
    import deplex_tpu.parallel.distributed as dist

    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    called = {}
    monkeypatch.setattr(
        "jax.distributed.initialize",
        lambda **kw: called.setdefault("args", kw))
    dist.initialize()
    assert "args" not in called
    # With the env contract set, it forwards rank/size/coordinator.
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    monkeypatch.setenv("JAX_PROCESS_ID", "1")
    dist.initialize()
    assert called["args"] == {"coordinator_address": "127.0.0.1:1",
                              "num_processes": 2, "process_id": 1}
