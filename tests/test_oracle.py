"""Serial numpy oracle vs reference goldens and vs the device pipeline.

The oracle (deplex_tpu/oracle/) re-derives the reference's serial semantics
in plain numpy; it anchors both directions: oracle==golden validates the
oracle against the real C++ output, pipeline~=oracle validates the
data-parallel recast against the serial semantics on arbitrary inputs (here: a crop, so
the test stays fast).
"""

import numpy as np

from deplex_tpu import Config, PlaneExtractor
from deplex_tpu.oracle import extract_planes_oracle

from .conftest import label_f1, load_golden


def test_oracle_matches_reference_golden(tum_cloud):
    pts, h, w = tum_cloud
    labels = extract_planes_oracle(pts, h, w, Config())
    gold = load_golden("tum_default_labels")
    f1, p, r = label_f1(labels, gold)
    # The oracle replays the serial algorithm in float64; the residual 1.3%
    # vs the C++ build comes from f32-vs-f64 numeric tie-breaks in seed
    # selection / merge ordering (same residual the device pipeline shows).
    assert f1 >= 0.98, (f1, p, r)


def test_pipeline_matches_oracle_on_crop(tum_cloud):
    pts, h, w = tum_cloud
    ch, cw = 240, 320
    crop = pts.reshape(h, w, 3)[:ch, :cw].reshape(-1, 3)
    got = PlaneExtractor(ch, cw, Config()).process(crop)
    want = extract_planes_oracle(crop, ch, cw, Config())
    f1, p, r = label_f1(got, want)
    assert f1 >= 0.95, (f1, p, r)
