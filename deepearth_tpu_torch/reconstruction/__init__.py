"""Reconstruction side-pipeline of the PyTorch port: posed imagery, point
clouds, the interactive viewer, headless plots, and a differentiable
Gaussian-splat renderer on hand-written CUDA kernels (tile binning K8,
compositing K9-fwd / K9-bwd; :mod:`deepearth_tpu_torch.ops.splat`)."""

from .gaussian_splat import (
    Camera,
    GaussianScene,
    densify_and_prune,
    fit_scene,
    fit_scene_adaptive,
    init_scene,
    project_gaussians,
    prune_scene,
    quat_to_rotmat,
    render,
    render_tiled,
    reset_opacity,
)
from .geofusion_dataset import CameraIntrinsics, Frame, GeoFusionDataset
from .interactive import (
    ViewCloud,
    apply_view_transform,
    build_scene,
    candidate_transforms,
    euler_adjust_matrix,
    render_viewer_html,
    write_viewer,
)
from .visualize import (
    plot_attention_map,
    plot_observation_map,
    plot_point_cloud,
    save_render,
)
from .point_cloud import (
    depth_to_world_cloud,
    load_ply,
    save_ply,
    transform_points,
    unproject_depth,
    voxel_downsample,
)

__all__ = [
    "ViewCloud",
    "apply_view_transform",
    "build_scene",
    "candidate_transforms",
    "euler_adjust_matrix",
    "render_viewer_html",
    "write_viewer",
    "densify_and_prune",
    "fit_scene_adaptive",
    "reset_opacity",
    "plot_attention_map",
    "plot_observation_map",
    "plot_point_cloud",
    "save_render",
    "Camera",
    "GaussianScene",
    "fit_scene",
    "init_scene",
    "project_gaussians",
    "prune_scene",
    "quat_to_rotmat",
    "render",
    "render_tiled",
    "CameraIntrinsics",
    "Frame",
    "GeoFusionDataset",
    "depth_to_world_cloud",
    "load_ply",
    "save_ply",
    "transform_points",
    "unproject_depth",
    "voxel_downsample",
]
