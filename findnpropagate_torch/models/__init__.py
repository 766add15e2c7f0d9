"""Model layer of the port: nn.Modules assembled from the same YAML configs
as findnpropagate_tpu/models. `build_network(model_cfg, num_class,
dataset, device=None)` mirrors the reference's surface
(pcdet/models/__init__.py:16) and runs on CUDA unless `device` is named."""

from .detectors.detector3d import build_detector as build_network  # noqa: F401
