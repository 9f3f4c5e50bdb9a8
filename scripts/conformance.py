"""On-card conformance report: golden-label F1 for the shipped configs.

Runs the full pipeline on the GPU for the shipped dataset configs (TUM fr3
default, ICL-NUIM ini, TUM RANSAC ini) and reports, for each:

  * plane-label F1 vs the C++ reference goldens (data/golden/*.npz) — the
    bound is 0.95, except for RANSAC refinement, whose random 3-point
    samples bound cross-generator agreement (tests/test_refinement.py);
  * found planes (the largest label; reference: exactly 34 on TUM default,
    cpp/tests/test_plane_extractor.cpp:31);
  * agreement with the same pipeline on the CPU (F1 and identical pixels):
    informational, since sums run in another order there.

Fails without a GPU. Prints one JSON line and writes it to --out.

Usage:  python scripts/conformance.py  [--out chiprun_out/conformance.json]
"""

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np

CONFIGS = [
    ("tum_default", "tum/1341848230.910894.png", "TUM_fr3_long_val.K", None, 0.95),
    ("icl_ini", "icl_nuim/0.png", "ICL_living_room.K", "ICL_living_room.ini", 0.95),
    ("tum_ransac", "tum/1341848230.910894.png", "TUM_fr3_long_val.K",
     "TUM_fr3_long_val_ransac.ini", 0.30),
]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "conformance.json"))
    args = ap.parse_args()

    import jax

    from deplex_tpu import Config, PlaneExtractor
    from deplex_tpu.utils import DepthImage, read_intrinsics
    from deplex_tpu.utils.metrics import label_f1

    device = jax.devices()[0]
    if device.platform != "gpu":
        raise SystemExit("conformance.py: no GPU found; nothing was run")
    cpu = jax.devices("cpu")[0]
    report = {"device": device.device_kind, "configs": {}}
    ok = True
    for name, png, kfile, ini, least_f1 in CONFIGS:
        img = DepthImage(str(ROOT / "data" / png))
        K = read_intrinsics(str(ROOT / "data" / "configs" / kfile))
        cfg = Config.from_ini(str(ROOT / "data" / "configs" / ini)) if ini else Config()
        gold = np.load(ROOT / "data" / "golden" / f"{name}_labels.npz")["labels"]
        pcd = img.transform_to_pcd(K)
        labels = PlaneExtractor(img.height, img.width, cfg).process(pcd)
        with jax.default_device(cpu):
            cpu_labels = PlaneExtractor(img.height, img.width, cfg).process(pcd)
        f1 = label_f1(labels, gold)[0]
        entry = {"f1": round(f1, 4), "least_f1": least_f1,
                 "planes": int(labels.max()),
                 "f1_vs_cpu": round(label_f1(labels, cpu_labels)[0], 4),
                 "identical_pixels_vs_cpu": round(float(np.mean(labels == cpu_labels)), 4)}
        ok &= f1 >= least_f1
        if name == "tum_default":
            ok &= entry["planes"] == 34
        report["configs"][name] = entry

    report["pass"] = bool(ok)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2) + "\n")
    print(json.dumps(report))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
