"""The port's package exports at the paths the JAX package uses.

Each name below is exported by the JAX package at ``deepearth_tpu.<path>``;
the port exports its counterpart at ``deepearth_tpu_torch.<path>``, and the
exported object is the one its defining submodule holds (a re-export, not a
copy). Where the port's class has another name than JAX's (its DeepSeek
embedder loads torch weights, not flax ones), the port's name is checked.
"""

import importlib

import pytest

EXPORTS = [  # (package path, name, the port's defining submodule)
    ("", "PRESET_MODALITIES", "configs"),
    ("models", "config_from_hf", "models.hf_convert"),
    ("models", "convert_hf_state_dict", "models.hf_convert"),
    ("models", "load_hf_checkpoint", "models.hf_convert"),
    ("models", "DeepSeekForSequenceClassification", "models.deepseek"),
    ("ops", "HASH_PRIMES", "ops.hash_encoding"),
    ("ops", "yarn_get_mscale", "ops.rope"),
    ("serving", "HashEmbedder", "serving.language_server"),
    ("serving", "HFEmbedder", "serving.language_server"),
    ("serving", "LanguageClient", "serving.language_server"),
    ("serving", "LanguageEmbeddingService", "serving.language_server"),
    ("serving", "LanguageServer", "serving.language_server"),
    ("serving", "DeepSeekEmbedder", "serving.language_server"),
    ("utils", "get_logger", "utils.logging"),
    ("", "tiny_config", "configs"),
    ("", "small_config", "configs"),
    ("serving", "DashboardClient", "serving.client"),
    ("serving", "DashboardServer", "serving.server"),
    ("serving", "DataService", "serving.server"),
    ("utils", "EmbeddingProjector", "utils.projection"),
    *[("data", name, "data.mmap_store") for name in (
        "MMapEmbeddingLoader", "MMapEmbeddingWriter",
        "convert_arrays_to_store")],
    *[("data", name, "data.observations") for name in (
        "DatasetConfig", "ObservationDataset", "UnifiedDataCache",
        "VJEPA2_SHAPE", "image_level_mean", "reshape_vision_embedding",
        "spatial_attention_map", "spatial_patch", "temporal_frame")],
    *[("evaluation", name, "evaluation.ecosystems") for name in (
        "EcosystemCluster", "analyze_ecosystems", "ecosystem_map_html",
        "species_similarity")],
    *[("evaluation", name, "evaluation.retrieval") for name in (
        "cross_modal_retrieval", "retrieval_metrics")],
    *[("evaluation", name, "evaluation.spatiotemporal") for name in (
        "SpatiotemporalMetrics", "binned_rmse", "knn_weights", "morans_i",
        "temporal_consistency")],
    ("", "ShardingConfig", "configs"),
    *[("utils", name, "utils.logging") for name in (
        "setup_logging", "JSONLMetricWriter", "TensorBoardMetricWriter",
        "MultiWriter")],
    *[("data", name, "data.batches") for name in (
        "collate_observations", "device_prefetch", "echo_on_device",
        "threaded_producer")],
    *[("data", name, "data.transfer") for name in (
        "compress_batch", "decompress_on_device",
        "device_prefetch_compressed", "quantize_rows")],
    *[("data", name, "data.npy_dataset") for name in (
        "NpySampleDataset", "write_npy_dataset")],
    *[("data", name, "data.splits") for name in (
        "SplitConfig", "create_spatial_temporal_split", "haversine_km",
        "load_split", "save_split")],
    *[("data", name, "data.synthetic") for name in (
        "SyntheticConfig", "SyntheticEarthDataGenerator",
        "observations_to_batch")],
    *[("geospatial", name, "geospatial.geodesy") for name in (
        "WGS84_A", "WGS84_E2", "WGS84_F", "GeospatialConverter",
        "ecef_to_geodetic", "geodetic_to_ecef", "ned_to_ecef_rotation",
        "rotation_to_ypr", "ypr_to_rotation")],
    *[("geospatial", name, "geospatial.geofusion") for name in (
        "GeoFusionDataLoader", "GeoFusionEntry")],
    *[("geospatial", name, "geospatial.structures") for name in (
        "BoundingBox", "CoordinateSet", "GeoOrientation", "GeoPoint")],
    *[("geospatial", name, "geospatial.utils") for name in (
        "human_unit", "safe_div", "wrap_lat", "wrap_lat_array",
        "wrap_lat_error", "wrap_lon_error")],
    *[("models", name, "models.transformer") for name in (
        "MultiHeadAttention", "TransformerBlock", "Transformer")],
    ("models", "ModalityEncoder", "models.encoders"),
    ("models", "HierarchicalFusion", "models.fusion"),
    *[("models", name, "models.simulator") for name in (
        "InductiveSimulator", "create_inductive_simulator",
        "MaskingStrategy", "DatasetSpecificDecoder")],
    *[("models", name, "models.shared_space") for name in (
        "LatentPool", "MultimodalSharedSpace")],
    *[("models", name, "models.bidirectional") for name in (
        "VisionSequenceDecoder", "BidirectionalReconstructor",
        "MultimodalAutoencoder")],
    *[("models", name, "models.mlp_unet") for name in (
        "MLPUNet", "MultimodalUNet", "BimodalMLPUNet", "species_topk")],
    *[("training", name, "training.recipes") for name in (
        "frozen_optimizer", "make_bidirectional_step",
        "make_autoencoder_step", "create_vision_decoder_finetune_state")],
    *[("reconstruction", name, "reconstruction.gaussian_splat") for name in (
        "Camera", "GaussianScene", "densify_and_prune", "fit_scene",
        "fit_scene_adaptive", "init_scene", "project_gaussians",
        "prune_scene", "quat_to_rotmat", "render", "render_tiled",
        "reset_opacity")],
    *[("reconstruction", name, "reconstruction.geofusion_dataset")
      for name in ("CameraIntrinsics", "Frame", "GeoFusionDataset")],
    *[("reconstruction", name, "reconstruction.interactive") for name in (
        "ViewCloud", "apply_view_transform", "build_scene",
        "candidate_transforms", "euler_adjust_matrix", "render_viewer_html",
        "write_viewer")],
    *[("reconstruction", name, "reconstruction.visualize") for name in (
        "plot_attention_map", "plot_observation_map", "plot_point_cloud",
        "save_render")],
    *[("reconstruction", name, "reconstruction.point_cloud") for name in (
        "depth_to_world_cloud", "load_ply", "save_ply", "transform_points",
        "unproject_depth", "voxel_downsample")],
    *[("evaluation", name, "evaluation.probes") for name in (
        "DeepEarthEvaluator", "ProbeResult", "classification_metrics",
        "regression_metrics")],
    *[("utils", name, "export") for name in (
        "export_forward", "export_model_forward", "load_exported")],
    *[("utils", name, "utils.monitor") for name in (
        "ResourceMonitor", "resource_snapshot")],
    *[("utils", name, "utils.profiling") for name in (
        "StepTimer", "benchmark_fn", "trace")],
]


def _module(path: str):
    return importlib.import_module(
        "deepearth_tpu_torch" + (f".{path}" if path else ""))


@pytest.mark.parametrize("path,name,source", EXPORTS,
                         ids=[f"{p or 'top'}.{n}" for p, n, _ in EXPORTS])
def test_port_exports_the_jax_package_names(path, name, source):
    package = _module(path)
    assert name in package.__all__
    assert getattr(package, name) is getattr(_module(source), name)
