"""Plane-landmark SLAM stack (new capability).

The reference library stops at per-frame plane labels; this subpackage adds
the downstream pipeline from BASELINE.json's north star: plane association
(`association`), Gauss-Newton odometry (`odometry`), windowed plane-landmark
bundle adjustment with Schur-complement reduction (`ba`), pose-graph
optimization (`pose_graph`), the streaming frontend (`frontend.PlaneSlam`)
and checkpointing (`checkpoint`). Distribution: keyframe/edge axes shard
over a jax mesh; global reductions are psum/all_gather inside shard_map.
"""

from deplex_tpu.slam.association import AssociationParams, Matches, associate
from deplex_tpu.slam.ba import BAProblem, BAState, ba_step, run_ba
from deplex_tpu.slam.frontend import MapState, PlaneSlam, init_map
from deplex_tpu.slam.odometry import OdometryResult, estimate_pose
from deplex_tpu.slam.planes import PlaneObs, from_cp, to_cp, transform_plane, untransform_plane
from deplex_tpu.slam.pose_graph import PoseGraph, graph_cost, optimize_pose_graph

__all__ = [
    "AssociationParams", "Matches", "associate",
    "BAProblem", "BAState", "ba_step", "run_ba",
    "MapState", "PlaneSlam", "init_map",
    "OdometryResult", "estimate_pose",
    "PlaneObs", "from_cp", "to_cp", "transform_plane", "untransform_plane",
    "PoseGraph", "graph_cost", "optimize_pose_graph",
]
