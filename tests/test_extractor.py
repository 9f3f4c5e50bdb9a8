"""PlaneExtractor behavioral + golden conformance tests.

Mirrors cpp/tests/test_plane_extractor.cpp and
python/tests/test_plane_extraction.py; the exact-34-planes assertion becomes
an F1-vs-reference-labels bound per BASELINE.md (the device pipeline reorders
the serial consume-the-histogram loop, so bit-exact label equality is not the
conformance criterion — per-pixel matched-plane F1 >= 0.95 is).
"""

import numpy as np
import pytest

from deplex_tpu import Config, PlaneExtractor

from .conftest import label_f1, load_golden


class TestGoldenConformance:
    def test_tum_default(self, tum_cloud):
        pts, h, w = tum_cloud
        labels = PlaneExtractor(h, w, Config()).process(pts)
        gold = load_golden("tum_default_labels")
        f1, p, r = label_f1(labels, gold)
        assert f1 >= 0.95, (f1, p, r)

    def test_tum_plane_count_close_to_34(self, tum_cloud):
        """Reference finds exactly 34 (test_plane_extractor.cpp:31)."""
        pts, h, w = tum_cloud
        labels = PlaneExtractor(h, w, Config()).process(pts)
        n = np.unique(labels[labels > 0]).size
        assert 27 <= n <= 41, n

    def test_icl_default(self, icl_cloud):
        pts, h, w = icl_cloud
        labels = PlaneExtractor(h, w, Config()).process(pts)
        gold = load_golden("icl_default_labels")
        f1, p, r = label_f1(labels, gold)
        assert f1 >= 0.95, (f1, p, r)

    def test_label_size_invariant(self, tum_cloud):
        """Labels always H*W (test_plane_extractor.cpp:44)."""
        pts, h, w = tum_cloud
        labels = PlaneExtractor(h, w).process(pts)
        assert labels.shape == (h * w,)
        assert labels.dtype == np.int32


class TestEdgeCases:
    """test_plane_extractor.cpp:35-91."""

    def test_impossible_planarity_score_all_zero(self, tum_cloud):
        pts, h, w = tum_cloud
        cfg = Config(min_region_planarity_score=2.0)  # score is a ratio <= 1
        labels = PlaneExtractor(h, w, cfg).process(pts)
        assert (labels == 0).all()

    def test_huge_patch_size_all_zero(self, tum_cloud):
        pts, h, w = tum_cloud
        cfg = Config(patch_size=10**6)
        labels = PlaneExtractor(h, w, cfg).process(pts)
        assert labels.shape == (h * w,)
        assert (labels == 0).all()

    def test_zero_patch_size_raises(self):
        with pytest.raises(ValueError):
            PlaneExtractor(480, 640, Config(patch_size=0))

    def test_zero_cloud_all_zero(self):
        pts = np.zeros((480 * 640, 3), np.float32)
        labels = PlaneExtractor(480, 640).process(pts)
        assert (labels == 0).all()

    def test_empty_input_raises(self):
        with pytest.raises(ValueError):
            PlaneExtractor(480, 640).process(np.zeros((0, 3), np.float32))

    def test_shape_mismatch_raises(self, tum_cloud):
        pts, h, w = tum_cloud
        with pytest.raises(ValueError):
            PlaneExtractor(h, w).process(pts[: h * w // 2])
