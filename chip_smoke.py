"""Run the plane extractor's main path on an NVIDIA GPU and check every part.

    python chip_smoke.py              # one card: every phase below
    python chip_smoke.py --chips 4    # only the four-card path and its check

Phases (one card):
  1. device   the card, its power limit and the XLA flags in effect
  2. build    the CUDA kernel library (deplex_tpu/cuda), timed
  3. kernels  each kernel against the plain XLA reference on the same
              inputs, and against the CPU, at TUM VGA (P=10, B=64 and B=1),
              ICL (P=4) and synthetic 720p (P=8), with their times
  4. e2e      DepthImage -> PlaneExtractor / extract_depth_batch against
              the reference goldens; the 720p scene at B=8
  5. timing   frames/s at B=64 and the B=1 latency, kernels against the
              all-XLA pipeline (informational)
  6. slam     PlaneSlam over a warped TUM sequence, then refine(), ATE bound

Any failed check raises, and the script exits non-zero. The last line of
standard output is one JSON object, {"ok": true, "device": {...}}, printed
only when every phase passed. Without a GPU the script fails at once.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
DATA = ROOT / "data"


def log(msg: str = "") -> None:
    print(msg, flush=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def require_gpu():
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU found (JAX sees "
                         f"{devices[0].platform!r}); nothing was run")
    return devices


def wall(fn, *args, reps: int = 7) -> float:
    """Median seconds of fn(*args) after one warm-up call, each call run to
    completion on the device."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def close_per_slot(got, ref, rtol: float, what: str) -> None:
    """|got - ref| <= rtol * the slot's magnitude (its vector norm, or its
    matrix trace), for arrays shaped (..., slot[, 3[, 3]])."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if ref.ndim >= 2 and ref.shape[-2:] == (3, 3):
        scale = np.abs(np.trace(ref, axis1=-2, axis2=-1))[..., None, None]
    elif ref.shape[-1:] == (3,):
        scale = np.linalg.norm(ref, axis=-1, keepdims=True)
    else:
        scale = np.abs(ref)
    err = np.abs(got - ref)
    bad = err > rtol * scale + 1e-30
    check(not bad.any(), f"{what}: {int(bad.sum())} entries beyond rtol {rtol}, "
          f"worst {float((err / np.maximum(scale, 1e-30)).max()):.3g}")


# --------------------------------------------------------------------------
# inputs

def tum_frame():
    from deplex_tpu.utils import DepthImage, read_intrinsics

    img = DepthImage(str(DATA / "tum" / "1341848230.910894.png"))
    K = np.asarray(read_intrinsics(str(DATA / "configs" / "TUM_fr3_long_val.K")),
                   np.float32)
    return img.data, K


def icl_frame():
    from deplex_tpu.utils import DepthImage, read_intrinsics

    img = DepthImage(str(DATA / "icl_nuim" / "0.png"))
    K = np.asarray(read_intrinsics(str(DATA / "configs" / "ICL_living_room.K")),
                   np.float32)
    return img.data, K


def mixed_batch(depth: np.ndarray, n: int, seed: int = 0) -> np.ndarray:
    """n distinct frames from one: small shifts, frame 0 unchanged."""
    rng = np.random.default_rng(seed)
    out = [depth]
    for _ in range(n - 1):
        dr, dc = rng.integers(-6, 7, size=2)
        out.append(np.roll(depth, (int(dr), int(dc)), axis=(0, 1)))
    return np.stack(out)


def hires_batch(n: int, seed: int = 0):
    """The synthetic 1280x720 scene of tests/test_stress.py (floor, back
    wall, side wall), with independent sensor noise per frame."""
    H, W = 720, 1280
    fx = fy = 1000.0
    cx, cy = W / 2 - 0.5, H / 2 - 0.5
    u = (np.arange(W, dtype=np.float32)[None, :] - cx) / fx
    v = (np.arange(H, dtype=np.float32)[:, None] - cy) / fy
    z_floor = np.where(v > 0.15, 1000.0 / np.maximum(v, 0.15), np.inf)
    z_side = np.where(u > 0.15, 1500.0 / np.maximum(u, 0.15), np.inf)
    z = np.minimum(np.minimum(z_floor, np.float32(4000.0)), z_side)
    rng = np.random.default_rng(seed)
    frames = (z[None] + rng.normal(scale=2.0, size=(n, H, W))).astype(np.float32)
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    return frames, K


# --------------------------------------------------------------------------
# phase 3: kernels against the reference

def shapes():
    """(name, depth batch, K, config) for every shape the kernels are
    checked and timed at."""
    from deplex_tpu import Config

    tum, K_tum = tum_frame()
    icl, K_icl = icl_frame()
    hires, K_hi = hires_batch(8)
    icl_cfg = Config.from_ini(str(DATA / "configs" / "ICL_living_room.ini"))
    return [
        ("tum_vga_p10_b64", mixed_batch(tum, 64), K_tum, Config()),
        ("tum_vga_p10_b1", tum[None], K_tum, Config()),
        ("icl_p4_b8", mixed_batch(icl, 8, seed=1), K_icl, icl_cfg),
        ("synth_720p_p8_b8", hires, K_hi, Config(patch_size=8, max_planes=32)),
    ]


def batch_stats(depth, K, cfg):
    import jax

    from deplex_tpu.ops.cellstats import compute_cell_stats
    from deplex_tpu.pipeline import backproject_device

    H, W = depth.shape[1:]
    fn = jax.jit(jax.vmap(lambda d: compute_cell_stats(
        backproject_device(d, K), H, W, cfg)))
    return fn(depth)


def phase_kernels(card: str) -> None:
    import jax

    from deplex_tpu.ops import cellstats
    from deplex_tpu.ops.growing import (admissibility_edges, finalize_rounds,
                                        grow_decisions, grow_rounds,
                                        grow_rounds_cuda)
    from deplex_tpu.ops.histogram import normal_bins
    from deplex_tpu.ops.merge import merge_planes
    from deplex_tpu.ops.merge_triton import merge_planes_triton
    from deplex_tpu.oracle.reference_impl import cell_moments_oracle
    from deplex_tpu.pipeline import backproject_device

    cpu = jax.devices("cpu")[0]
    for name, depth, K, cfg in shapes():
        B, H, W = depth.shape
        d_dev = jax.device_put(depth)
        stats = batch_stats(d_dev, K, cfg)

        # Growing: bit-equal integer decisions.
        xla_grow = jax.jit(jax.vmap(lambda s: grow_rounds(s, cfg)))
        cuda_grow = jax.jit(jax.vmap(lambda s: grow_rounds_cuda(s, cfg)))
        ref, got = xla_grow(stats), cuda_grow(stats)
        for f in ("round_map", "seeds", "nr_rounds"):
            check(np.array_equal(np.asarray(getattr(got, f)),
                                 np.asarray(getattr(ref, f))),
                  f"{name}: growing kernel {f} differs from grow_rounds")
        # ... and against the CPU, on the same raw inputs.
        nb = cfg.histogram_bins_per_coord
        raw = jax.jit(jax.vmap(lambda s: (
            normal_bins(s.normal, s.planar, nb), s.mse,
            admissibility_edges(s, cfg), s.planar)))(stats)
        raw_cpu = jax.device_put(jax.device_get(raw), cpu)
        cpu_dec = jax.jit(jax.vmap(lambda b, m, e, p: grow_decisions(
            b, m, e, p, cfg)))(*raw_cpu)
        for f, a in zip(("round_map", "seeds", "nr_rounds"), cpu_dec):
            check(np.array_equal(np.asarray(a), np.asarray(getattr(got, f))),
                  f"{name}: growing kernel {f} differs from the CPU")

        # Merge: equal labels, merged statistics to rtol 1e-5.
        lm, seg = jax.jit(jax.vmap(lambda r: finalize_rounds(r, cfg)))(got)
        xla_merge = jax.jit(jax.vmap(lambda l, s: merge_planes(l, s, cfg)))
        tri_merge = jax.jit(jax.vmap(lambda l, s: merge_planes_triton(l, s, cfg)))
        ml_ref, m_ref = xla_merge(lm, seg)
        ml_got, m_got = tri_merge(lm, seg)
        check(np.array_equal(np.asarray(ml_got), np.asarray(ml_ref)),
              f"{name}: merge kernel labels differ from merge_planes")
        for f in ("n", "coord_sum", "scatter", "mean", "d"):
            close_per_slot(getattr(m_got, f), getattr(m_ref, f), 1e-5,
                           f"{name}: merged {f}")
        ml_cpu, _ = jax.jit(jax.vmap(lambda l, s: merge_planes(l, s, cfg)))(
            *jax.device_put(jax.device_get((lm, seg)), cpu))
        check(np.array_equal(np.asarray(ml_cpu), np.asarray(ml_got)),
              f"{name}: merge kernel labels differ from the CPU")

        # Cell moments (first frame) against float64 numpy.
        P = min(cfg.patch_size, min(H, W))
        pts = backproject_device(d_dev[0], K)
        mom = jax.jit(lambda p: cellstats.compute_cell_moments(p, H, W, cfg))(pts)
        ora = cell_moments_oracle(np.asarray(pts), H, W, cfg)
        for f in ("nr_valid", "disc_h", "disc_v"):
            check(np.array_equal(np.asarray(getattr(mom, f)), ora[f]),
                  f"{name}: gate count {f} differs from float64 numpy")
        cs, ref_cs = np.asarray(mom.coord_sum), ora["coord_sum"]
        check(np.all(np.abs(cs - ref_cs) <= 1e-5 * np.abs(ref_cs) + 1e-3),
              f"{name}: coord_sum beyond rtol 1e-5 of float64")
        close_per_slot(mom.scatter, ora["scatter"], 1e-3,
                       f"{name}: scatter against float64")

        n_rounds = np.asarray(got.nr_rounds)
        log(f"[kernels] {name}: growing, merge and moments agree with the "
            f"reference and the CPU (rounds {n_rounds.min()}-{n_rounds.max()}, "
            f"planes {int(np.asarray(seg.nr_planes).max())})")

        # Times, each beside its XLA alternative.
        t = {"grow_cuda": wall(cuda_grow, stats), "grow_xla": wall(xla_grow, stats),
             "merge_triton": wall(tri_merge, lm, seg),
             "merge_xla": wall(xla_merge, lm, seg)}
        pts_b = jax.jit(jax.vmap(lambda d: backproject_device(d, K)))(d_dev)

        def moments_fn(form):
            def f(p):
                img = p.reshape(H, W, 3)[:H // P * P, :W // P * P]
                return form(img[..., 0], img[..., 1], img[..., 2], P)
            return jax.jit(jax.vmap(f))

        t["moments"] = wall(moments_fn(cellstats.cell_moments), pts_b)
        log(f"[timing] {card} | {name} B={B}: " + ", ".join(
            f"{k} {v * 1e3:.3f} ms" for k, v in t.items()))
        log("[timing-json] " + json.dumps({"shape": name, "batch": B, "card": card,
                                            "seconds": t}))


# --------------------------------------------------------------------------
# phase 4: end to end against the goldens

def load_golden(name: str) -> np.ndarray:
    return np.load(DATA / "golden" / f"{name}.npz")["labels"]


def phase_e2e() -> None:
    import jax

    from deplex_tpu import Config, PlaneExtractor
    from deplex_tpu.parallel.batch import extract_depth_batch_jit
    from deplex_tpu.utils import DepthImage, read_intrinsics
    from deplex_tpu.utils.metrics import label_f1

    cpu = jax.devices("cpu")[0]
    # (golden, frame, intrinsics, ini, least F1). The RANSAC golden's bound is
    # tests/test_refinement.py's: its survivors are 1-unit slabs whose
    # placement follows the random 3-point samples, so labels from another
    # generator than the reference's agree to F1 ~0.36 at best.
    cases = [
        ("tum_default", "tum/1341848230.910894.png", "TUM_fr3_long_val", None, 0.95),
        ("icl_ini", "icl_nuim/0.png", "ICL_living_room", "ICL_living_room.ini", 0.95),
        ("tum_ransac", "tum/1341848230.910894.png", "TUM_fr3_long_val",
         "TUM_fr3_long_val_ransac.ini", 0.30),
    ]
    for golden, png, kname, ini, least_f1 in cases:
        img = DepthImage(str(DATA / png))
        K = read_intrinsics(str(DATA / "configs" / f"{kname}.K"))
        cfg = Config.from_ini(str(DATA / "configs" / ini)) if ini else Config()
        ext = PlaneExtractor(img.height, img.width, cfg)
        pcd = img.transform_to_pcd(K)
        labels = ext.process(pcd)
        f1, _, _ = label_f1(labels, load_golden(f"{golden}_labels"))
        # Planes found = plane segments before merging = the largest label,
        # as the reference counts them (34 on the TUM frame).
        n_planes = int(labels.max())
        check(f1 >= least_f1, f"{golden}: F1 {f1:.4f} below {least_f1}")
        if golden == "tum_default":
            check(n_planes == 34, f"tum_default: {n_planes} planes, not 34")
        depth_labels = ext.process_depth(img.data, K)
        f1_depth, _, _ = label_f1(depth_labels, load_golden(f"{golden}_labels"))
        check(f1_depth >= least_f1, f"{golden}: process_depth F1 {f1_depth:.4f}")
        if ini and "ransac" in ini:
            kept, kept_gold = int((labels > 0).sum()), int((load_golden(
                f"{golden}_labels") > 0).sum())
            check(0.4 * kept_gold <= kept <= 1.6 * kept_gold,
                  f"{golden}: {kept} labeled pixels vs {kept_gold} in the golden")
        with jax.default_device(cpu):
            cpu_labels = PlaneExtractor(img.height, img.width, cfg).process(pcd)
        agree, _, _ = label_f1(labels, cpu_labels)
        same = float(np.mean(labels == cpu_labels))
        log(f"[e2e] {golden}: {n_planes} planes "
            f"({np.unique(labels[labels > 0]).size} after merging), F1 {f1:.4f} (process), "
            f"{f1_depth:.4f} (process_depth); GPU vs CPU labels: F1 "
            f"{agree:.4f}, identical pixels {same:.4f}")

    # B=64 labels equal B=1 labels, frame by frame.
    tum, K = tum_frame()
    batch = mixed_batch(tum, 64)
    out64 = np.asarray(extract_depth_batch_jit(batch, K, config=Config()))
    for i in range(len(batch)):
        one = np.asarray(extract_depth_batch_jit(batch[i:i + 1], K, config=Config()))
        check(np.array_equal(out64[i], one[0]), f"B=64 frame {i} differs from B=1")
    log(f"[e2e] extract_depth_batch: B={len(batch)} labels equal B=1 labels "
        "for every frame")

    # 720p synthetic scene at B=8 (the bounds of tests/test_stress.py).
    frames, K_hi = hires_batch(8)
    cfg = Config(patch_size=8, max_planes=32)
    out = np.asarray(extract_depth_batch_jit(frames, K_hi, config=cfg))
    for i, lab in enumerate(out):
        n = np.unique(lab[lab > 0]).size
        check(2 <= n <= 12, f"720p frame {i}: {n} planes")
        check((lab > 0).mean() > 0.5, f"720p frame {i}: coverage {(lab > 0).mean()}")
    log(f"[e2e] 720p synthetic B=8: planes per frame "
        f"{[int(np.unique(lab[lab > 0]).size) for lab in out]}")


# --------------------------------------------------------------------------
# phase 5: informational end-to-end timings

def xla_only_batch(depth, K, cfg):
    """The whole batched pipeline with the XLA loops in place of the
    growing and merge kernels (the baseline the kernels are judged by)."""
    import jax

    from deplex_tpu.ops.cellstats import compute_cell_stats
    from deplex_tpu.ops.growing import finalize_rounds, grow_rounds
    from deplex_tpu.ops.merge import merge_planes, rasterize_labels
    from deplex_tpu.pipeline import backproject_device

    B, H, W = depth.shape
    P = min(cfg.patch_size, min(H, W))

    def one(d):
        stats = compute_cell_stats(backproject_device(d, K), H, W, cfg)
        lm, seg = finalize_rounds(grow_rounds(stats, cfg), cfg)
        ml, _ = merge_planes(lm, seg, cfg)
        return rasterize_labels(lm, ml, H, W, P)

    return jax.vmap(one)(depth).astype(np.uint8)


def phase_timing(card: str) -> None:
    import functools

    import jax

    from deplex_tpu import Config
    from deplex_tpu.parallel.batch import extract_depth_batch_jit

    tum, K = tum_frame()
    cfg = Config()
    Kd = jax.device_put(K)
    xla_jit = jax.jit(functools.partial(xla_only_batch, cfg=cfg))
    for B in (64, 1):
        batch = jax.device_put(mixed_batch(tum, B))
        t_k = wall(lambda d: extract_depth_batch_jit(d, Kd, config=cfg), batch)
        t_x = wall(lambda d: xla_jit(d, Kd), batch)
        same = np.array_equal(np.asarray(extract_depth_batch_jit(batch, Kd, config=cfg)),
                              np.asarray(xla_jit(batch, Kd)))
        log(f"[timing] {card} | TUM VGA B={B}: kernels {B / t_k:.1f} frames/s "
            f"({t_k * 1e3:.3f} ms/batch), all-XLA {B / t_x:.1f} frames/s "
            f"({t_x * 1e3:.3f} ms/batch); labels identical: {same}")
        log("[timing-json] " + json.dumps({"shape": f"e2e_tum_vga_b{B}", "batch": B,
                                            "card": card, "seconds": {
                                                "kernels": t_k, "xla": t_x}}))


# --------------------------------------------------------------------------
# phase 6: SLAM

def phase_slam() -> None:
    import jax.numpy as jnp

    from deplex_tpu import Config
    from deplex_tpu.pipeline import backproject_device
    from deplex_tpu.slam import PlaneSlam
    from deplex_tpu.utils.warp import render_sequence, smooth_trajectory

    tum, K = tum_frame()
    depth0 = tum[::2, ::2]
    K2 = K.copy()
    K2[:2] *= 0.5
    poses = smooth_trajectory(30, seed=0)
    frames = render_sequence(depth0, K2, poses)
    H, W = depth0.shape
    slam = PlaneSlam(H, W, Config(patch_size=5), max_landmarks=64,
                     odom_iterations=10)
    t0 = time.perf_counter()
    for d in frames:
        depth = np.clip(np.round(d), 0, 65535).astype(np.uint16)
        slam.process_frame(backproject_device(jnp.asarray(depth), jnp.asarray(K2)))
    t_track = time.perf_counter() - t0

    def ate():
        errs = [np.linalg.norm(-R.T @ t - (-Rg.T @ tg))
                for (R, t), (Rg, tg) in zip(slam.trajectory, poses)]
        return float(np.sqrt(np.mean(np.square(errs))))

    ate_track = ate()
    check(len(slam.trajectory) == 30, "SLAM lost frames")
    check(ate_track < 300.0, f"tracking ATE {ate_track:.1f} mm >= 300")
    t0 = time.perf_counter()
    slam.refine(iterations=10)
    t_refine = time.perf_counter() - t0
    ate_ba = ate()
    check(ate_ba <= 1.05 * ate_track, f"refine() ATE {ate_ba:.1f} > 1.05 x {ate_track:.1f}")
    log(f"[slam] 30 warped TUM frames: tracking ATE {ate_track:.2f} mm, after "
        f"refine() {ate_ba:.2f} mm; tracking {t_track:.2f} s incl. compile, "
        f"refine {t_refine:.2f} s incl. compile")


# --------------------------------------------------------------------------
# four cards

def phase_four_cards(devices) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from deplex_tpu import Config
    from deplex_tpu.parallel.batch import BatchPlaneExtractor, ShardedPlaneExtractor
    from deplex_tpu.pipeline import backproject_device
    from deplex_tpu.slam.ba import BAProblem, run_ba, run_ba_sharded
    from deplex_tpu.slam.lie import so3_exp
    from deplex_tpu.slam.planes import to_cp, transform_plane

    check(len(devices) == 4, f"--chips 4 needs 4 GPUs, JAX sees {len(devices)}")
    mesh = Mesh(np.array(devices), axis_names=("data",))
    tum, K = tum_frame()
    H, W = tum.shape
    batch = mixed_batch(tum, 256, seed=3)
    pts = np.asarray(jax.jit(jax.vmap(lambda d: backproject_device(d, K)))(batch))
    sharded = ShardedPlaneExtractor(H, W, Config(), mesh=mesh)
    t_s = wall(sharded.process, pts, reps=3)
    got = sharded.process(pts)
    with jax.default_device(devices[0]):
        single = BatchPlaneExtractor(H, W, Config())
        t_1 = wall(single.process, pts, reps=3)
        ref = single.process(pts)
    check(np.array_equal(got, ref), "4-card labels differ from the single-card run")
    log(f"[4-card] ShardedPlaneExtractor B=256 over 4 cards: labels equal the "
        f"single-card run; {t_s * 1e3:.1f} ms vs {t_1 * 1e3:.1f} ms per batch "
        "(host to device copy included)")

    rng = np.random.default_rng(0)
    M, Kf = 16, 8
    n_w = rng.normal(size=(M, 3)).astype(np.float32)
    n_w /= np.linalg.norm(n_w, axis=1, keepdims=True)
    d_w = rng.uniform(500, 3000, size=M).astype(np.float32)
    Rk = so3_exp(jnp.asarray(rng.normal(size=(Kf, 3)).astype(np.float32) * 0.1))
    tk = jnp.asarray((rng.normal(size=(Kf, 3)) * 50).astype(np.float32))
    n_c, d_c = jax.vmap(transform_plane, in_axes=(0, 0, None, None))(
        Rk, tk, jnp.asarray(n_w), jnp.asarray(d_w))
    noise = jnp.asarray(rng.normal(size=n_c.shape).astype(np.float32) * 0.01)
    prob = BAProblem(
        R=Rk, t=tk, eta=to_cp(jnp.asarray(n_w), jnp.asarray(d_w) + 5.0),
        obs_normal=n_c + noise, obs_d=d_c,
        obs_lm=jnp.broadcast_to(jnp.arange(M), (Kf, M)).astype(jnp.int32),
        obs_w=jnp.ones((Kf, M), jnp.float32))
    dense = run_ba(prob, iterations=4)
    shard = run_ba_sharded(prob, mesh=mesh, axis="data", iterations=4)
    dR = float(jnp.abs(dense.R - shard.R).max())
    check(dR < 1e-3, f"run_ba_sharded disagrees with run_ba: {dR}")
    log(f"[4-card] run_ba_sharded over 4 cards matches run_ba: max |dR| {dR:.2e}")


# --------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: run only the four-card path and its comparison")
    args = ap.parse_args(argv)

    devices = require_gpu()
    import jax

    card = card_line()
    log(card)      # name and power limit, as nvidia-smi prints them
    log(f"[device] JAX {jax.__version__}: {len(devices)} x {devices[0].device_kind} "
        f"({devices[0].platform})")
    log(f"[device] XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")

    if args.chips == 4:
        phase_four_cards(devices[:4])
    else:
        from deplex_tpu import cuda

        t0 = time.perf_counter()
        path = cuda.build()
        cuda.register()
        log(f"[build] {path.name} ready in {time.perf_counter() - t0:.1f} s")
        phase_kernels(card)
        phase_e2e()
        phase_timing(card)
        phase_slam()

    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
