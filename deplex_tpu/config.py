"""Algorithm configuration for the deplex-tpu plane extractor.

Mirrors the 16 tunables of the reference implementation
(/root/reference/cpp/deplex/include/deplex/config.h:51-81) with identical
defaults and INI key names (config.cpp:44-75), plus static options that
control compiled-shape bounds (``max_planes``,
``max_region_growing_rounds``) which have no reference analog because the
serial C++ code has no need for static shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Union


@dataclasses.dataclass(frozen=True)
class Config:
    """Plane-extraction parameters.

    Frozen (hashable) so a Config can be used as a static jit argument.
    Field names follow the reference C++ struct; INI keys follow the
    reference parser (camelCase).
    """

    # Cell (patch) side length, unit: pixels.
    patch_size: int = 10
    # Seed selection: bins per spherical coordinate in the normals histogram.
    histogram_bins_per_coord: int = 20
    # cos(angle) threshold for merging two regions.
    min_cos_angle_merge: float = 0.90
    # Distance between two regions threshold, unit: mm (squared-compare).
    max_merge_dist: float = 500.0
    # Minimum number of cells in the dominant histogram bin to keep growing.
    min_region_growing_candidate_size: int = 5
    # Minimum number of activated cells for a region to be considered.
    min_region_growing_cells_activated: int = 4
    # Planarity score (lambda_max / sum(lambda)) threshold for a region.
    min_region_planarity_score: float = 0.55
    # Depth-adaptive planarity threshold: (coeff * z^2 + margin)^2 >= MSE.
    depth_sigma_coeff: float = 1.425e-6
    depth_sigma_margin: float = 10.0
    # A cell needs >= cell_points_total*3 / min_pts_per_cell valid points.
    min_pts_per_cell: int = 3
    # Depth jump (mm) between adjacent pixels counted as a discontinuity.
    depth_discontinuity_threshold: float = 160.0
    # Maximum allowed discontinuity count along the mid row / mid column.
    max_number_depth_discontinuity: int = 1
    # RANSAC refinement stage.
    ransac_refinement: bool = False
    ransac_max_iterations: int = 1000
    ransac_threshold: float = 1.0
    ransac_inliers_ratio: float = 0.9
    # --- Static shape bounds of the compiled pipeline (no reference analog) ---
    # Maximum number of plane segments tracked inside the compiled pipeline.
    max_planes: int = 64
    # Upper bound on region-growing rounds (consumed-histogram loop).
    max_region_growing_rounds: int = 256
    # --- Cylinder extraction (CAPE's second primitive; not in the
    # reference library, SURVEY.md "Planes only") ---
    cylinder_extraction: bool = False
    min_cylinder_cells: int = 4
    max_cylinders: int = 16
    # Accept when radial RMSE <= max(cylinder_rmse_max, rel * radius) [mm].
    cylinder_rmse_max: float = 20.0
    cylinder_rmse_rel: float = 0.05

    def __post_init__(self):
        if self.patch_size < 0:
            raise ValueError(
                f"Error! Invalid config parameter: patchSize({self.patch_size})."
                " patchSize has to be positive."
            )

    @classmethod
    def from_ini(cls, config_path: str) -> "Config":
        """Parse the reference INI dialect: '#' comments, '[section]' headers
        ignored, 'key=value' lines, unknown keys warn (config.cpp:28-80)."""
        import sys

        try:
            with open(config_path, "r") as f:
                lines = f.read().splitlines()
        except OSError as e:
            raise RuntimeError(f"Couldn't open ini file: {config_path}") from e
        values = {}
        for line in lines:
            if not line or line[0] == "#":
                continue
            eq = line.find("=")
            if eq <= 0:
                continue
            key, value = line[:eq], line[eq + 1 :]
            field = _INI_KEYS.get(key)
            if field is None:
                print(f"Unknown parameter name: {key}", file=sys.stderr)
                continue
            typ = _FIELD_TYPES[field]
            if typ is bool:
                values[field] = bool(int(value))
            else:
                values[field] = typ(value)
        return cls(**values)

    @classmethod
    def from_dict(cls, param_map: Mapping[str, Union[str, int, float]]) -> "Config":
        """Construct from a key->value map. Accepts both INI-style camelCase
        keys and dataclass field names."""
        values = {}
        for key, value in param_map.items():
            field = _INI_KEYS.get(key, key)
            if field not in _FIELD_TYPES:
                raise KeyError(f"Unknown parameter name: {key}")
            typ = _FIELD_TYPES[field]
            values[field] = bool(int(value)) if typ is bool else typ(value)
        return cls(**values)

    def replace(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)


# INI key -> dataclass field (reference parser key set, config.cpp:44-75).
_INI_KEYS = {
    "patchSize": "patch_size",
    "histogramBinsPerCoord": "histogram_bins_per_coord",
    "minCosAngleForMerge": "min_cos_angle_merge",
    "maxMergeDist": "max_merge_dist",
    "minRegionGrowingCandidateSize": "min_region_growing_candidate_size",
    "minRegionGrowingCellsActivated": "min_region_growing_cells_activated",
    "minRegionPlanarityScore": "min_region_planarity_score",
    "depthSigmaCoeff": "depth_sigma_coeff",
    "depthSigmaMargin": "depth_sigma_margin",
    "minPtsPerCell": "min_pts_per_cell",
    "depthDiscontinuityThreshold": "depth_discontinuity_threshold",
    "maxNumberDepthDiscontinuity": "max_number_depth_discontinuity",
    "ransacRefinement": "ransac_refinement",
    "ransacMaxIterations": "ransac_max_iterations",
    "ransacThreshold": "ransac_threshold",
    "ransacInliersRatio": "ransac_inliers_ratio",
    # Extras beyond the reference, exposed under matching camelCase.
    "maxPlanes": "max_planes",
    "maxRegionGrowingRounds": "max_region_growing_rounds",
    "cylinderExtraction": "cylinder_extraction",
    "minCylinderCells": "min_cylinder_cells",
    "maxCylinders": "max_cylinders",
    "cylinderRmseMax": "cylinder_rmse_max",
    "cylinderRmseRel": "cylinder_rmse_rel",
}

_FIELD_TYPES = {f.name: f.type for f in dataclasses.fields(Config)}
# dataclasses stringifies annotations under `from __future__ import annotations`.
_FIELD_TYPES = {
    name: {"int": int, "float": float, "bool": bool}[
        t if isinstance(t, str) else t.__name__]
    for name, t in _FIELD_TYPES.items()
}
