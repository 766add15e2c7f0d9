"""VLM relabeling of 3D boxes: GLIP 2D-overlap scoring, MaskCLIP per-pixel
probabilities and CLIP crop scoring — port of findnpropagate_tpu/
openvocab/box_classification.py.

Each relabeler projects the boxes' corners into every camera
(`project_boxes_to_cameras`), scores the classes per camera, averages over
the cameras a box is visible in, and REPLACES the labels (argmax, 1-indexed)
and scores (max):

  * GLIPBoxClassification: IoU with the cached per-camera GLIP boxes of
    that camera, times one_hot(label) * score;
  * CLIPBoxClassificationMaskCLIP: the mean of MaskCLIP's per-pixel class
    probabilities over the pixels u, v with ceil(x1) <= u < ceil(x2),
    ceil(y1) <= v < ceil(y2) of the box's 2D extent — the reference's
    masked sum, here from a summed-area table accumulated in f64;
  * CLIPBoxClassification: square crops (>= crop_min px) sampled on a
    224 x 224 grid, their CLIP image features against the class text
    features (prompt ensemble), softmax at logit scale 100.

Batched torch on the device of the inputs, with no per-box loop. The CLIP
encoders are attributes a caller can set (`CLIPBoxClassification._model`
with `get_image_features`, `_text_features`; MaskCLIP's `_encode_dense`,
`_text_features`); left unset they load from the `transformers` package
and raise naming it and the weights when either is missing.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..utils.geometry import boxes_to_corners_3d
from .camera import boxes_2d_iou, project_to_camera

PROMPT_TEMPLATES = (
    "a photo of a {}",
    "a photo of the {}",
    "a photo of one {}",
)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
CROP = 224


def project_boxes_to_cameras(boxes3d, lidar2image, image_size=(900, 1600)):
    """(N, 7) boxes, (NCAM, 4, 4) -> per-camera 2D xyxy boxes (NCAM, N, 4),
    clamped to the image, and visibility (NCAM, N): every corner in front
    of the camera and the clamped box more than a pixel wide and tall."""
    corners = boxes_to_corners_3d(boxes3d)          # (N, 8, 3)
    n = corners.shape[0]
    coords, _ = project_to_camera(corners.reshape(-1, 3), lidar2image,
                                  image_size=image_size)
    ncam = coords.shape[0]
    uv = coords[..., :2].reshape(ncam, n, 8, 2)
    front = (coords[..., 2] > 1e-4).reshape(ncam, n, 8)
    h, w = image_size
    u = uv[..., 0].clamp(0, w)
    v = uv[..., 1].clamp(0, h)
    boxes2d = torch.stack([u.amin(dim=2), v.amin(dim=2), u.amax(dim=2),
                           v.amax(dim=2)], dim=-1)
    visible = front.all(dim=2) \
        & ((boxes2d[..., 2] - boxes2d[..., 0]) > 1) \
        & ((boxes2d[..., 3] - boxes2d[..., 1]) > 1)
    return boxes2d, visible


def camera_mean(probs, visible):
    """(NCAM, N, C) per-camera class scores -> labels (N,) int32
    1-indexed and scores (N,): the mean over the cameras each box is
    visible in (an invisible box scores 0, label 1)."""
    probs = (probs * visible[..., None]).sum(dim=0)
    seen = visible.sum(dim=0).clamp(min=1)
    probs = probs / seen[:, None]
    return probs.argmax(dim=-1).to(torch.int32) + 1, probs.amax(dim=-1)


class GLIPBoxClassification:
    """Relabel 3D detections from cached per-camera 2D GLIP boxes."""

    def __init__(self, num_classes: int, image_size=(900, 1600)):
        self.num_classes = num_classes
        self.image_size = image_size

    def relabel(self, boxes3d, lidar2image, det_boxes, det_labels, det_scores,
                det_cams, det_mask):
        """boxes3d (N, 7); cached 2D detections (D, ...) padded, det_mask
        (D,). Returns (labels (N,) 1-indexed, scores (N,))."""
        boxes2d, visible = project_boxes_to_cameras(
            boxes3d, lidar2image, self.image_size)
        ncam = visible.shape[0]
        mask = det_mask.to(torch.bool)
        classes = torch.arange(self.num_classes, device=det_labels.device)
        # one_hot(label - 1): a label outside 1..C gives a zero row
        onehot = (det_labels.long()[:, None] - 1 == classes).to(
            det_scores.dtype)
        weighted = onehot * (det_scores * mask)[:, None]          # (D, C)
        cams = torch.arange(ncam, device=det_cams.device)
        cam_sel = (det_cams.long()[None, :] == cams[:, None]) & mask
        iou = boxes_2d_iou(boxes2d, det_boxes[None]) * cam_sel[:, None, :]
        return camera_mean(iou @ weighted, visible)


def box_means(probs_px, boxes2d, visible):
    """Mean of the per-pixel probabilities (NCAM, H, W, C) over each box's
    pixels ceil(x1) <= u < ceil(x2), ceil(y1) <= v < ceil(y2) -> (NCAM, N,
    C), 0 where the box is not visible. The sums come from a summed-area
    table in f64 (one corner lookup each instead of a full-image mask per
    box), the mean is rounded to the probabilities' dtype."""
    ncam, h, w, c = probs_px.shape
    sat = torch.zeros((ncam, h + 1, w + 1, c), dtype=torch.float64,
                      device=probs_px.device)
    sat[:, 1:, 1:] = probs_px.to(torch.float64).cumsum(dim=2).cumsum(dim=1)
    lo = torch.ceil(boxes2d[..., :2])
    hi = torch.maximum(torch.ceil(boxes2d[..., 2:]), lo)
    x0, y0 = lo[..., 0].clamp(0, w).long(), lo[..., 1].clamp(0, h).long()
    x1, y1 = hi[..., 0].clamp(0, w).long(), hi[..., 1].clamp(0, h).long()
    cam = torch.arange(ncam, device=sat.device)[:, None]
    sums = sat[cam, y1, x1] - sat[cam, y0, x1] - sat[cam, y1, x0] \
        + sat[cam, y0, x0]
    count = ((x1 - x0) * (y1 - y0)).clamp(min=1)
    means = (sums / count[..., None]).to(probs_px.dtype)
    return torch.where(visible[..., None], means, torch.zeros_like(means))


class CLIPBoxClassificationMaskCLIP:
    """MaskCLIP relabel variant: per-pixel CLIP class probabilities from
    the dense encoder, averaged inside each box's projected 2D region per
    camera, then over the cameras the box appears in."""

    def __init__(self, class_names: Sequence[str],
                 image_size=(900, 1600), maskclip=None):
        from ..models.backbones_image.maskclip import MaskCLIP

        self.class_names = list(class_names)
        self.image_size = image_size
        self.maskclip = maskclip or MaskCLIP(class_names)

    def relabel(self, boxes3d, lidar2image, images):
        """boxes3d (N, 7); images (NCAM, H, W, 3) in [0, 1].
        Returns (labels (N,) 1-indexed, scores (N,))."""
        probs_px = self.maskclip.pixel_probs(images)       # (NCAM, H, W, C)
        boxes2d, visible = project_boxes_to_cameras(
            boxes3d, lidar2image, self.image_size)
        return camera_mean(box_means(probs_px, boxes2d, visible), visible)


class CLIPBoxClassification:
    """CLIP crop scoring."""

    def __init__(self, class_names: Sequence[str],
                 model_name: str = "openai/clip-vit-base-patch32",
                 image_size=(900, 1600), crop_min: int = 64,
                 prompt_ensemble: bool = True):
        self.class_names = list(class_names)
        self.image_size = image_size
        self.crop_min = crop_min
        self.prompt_ensemble = prompt_ensemble
        self.model_name = model_name
        self._model = None
        self._text_features = None

    def _load(self):
        if self._model is not None and self._text_features is not None:
            return
        try:
            from transformers import CLIPModel, CLIPTokenizer
            model = CLIPModel.from_pretrained(self.model_name,
                                              local_files_only=True)
            tokenizer = CLIPTokenizer.from_pretrained(
                self.model_name, local_files_only=True)
        except (ImportError, OSError) as e:
            raise RuntimeError(
                f"CLIP relabeling needs the `transformers` package and the "
                f"weights and vocabulary of {self.model_name!r} on disk; set "
                "`_model` and `_text_features` to use another encoder "
                f"({type(e).__name__}: {e})") from e
        model.eval()
        prompts = []
        for name in self.class_names:
            name = name.replace("_", " ")
            prompts.extend(t.format(name) for t in (
                PROMPT_TEMPLATES if self.prompt_ensemble
                else PROMPT_TEMPLATES[:1]))
        with torch.no_grad():
            feats = model.get_text_features(
                **tokenizer(prompts, return_tensors="pt", padding=True))
        feats = feats / feats.norm(dim=-1, keepdim=True)
        if self.prompt_ensemble:
            feats = feats.reshape(len(self.class_names),
                                  len(PROMPT_TEMPLATES), -1).mean(dim=1)
            feats = feats / feats.norm(dim=-1, keepdim=True)
        self._model, self._text_features = model, feats          # (C, E)

    def crop_boxes(self, images, boxes2d):
        """(NCAM, H, W, 3) images, (NCAM, N, 4) boxes -> (NCAM, N, 224,
        224, 3) square crops of side max(w, h, crop_min) around the box
        centre: the pixels at y1 + (i + 0.5) * s / 224 (and x likewise),
        f32 and truncated, as the reference samples them."""
        h_img, w_img = self.image_size
        cx = (boxes2d[..., 0] + boxes2d[..., 2]) / 2
        cy = (boxes2d[..., 1] + boxes2d[..., 3]) / 2
        size = torch.maximum(
            torch.maximum(boxes2d[..., 2] - boxes2d[..., 0],
                          boxes2d[..., 3] - boxes2d[..., 1]),
            torch.tensor(float(self.crop_min), dtype=boxes2d.dtype,
                         device=boxes2d.device))
        x1 = (cx - size / 2).clamp(0, w_img - 1)
        y1 = (cy - size / 2).clamp(0, h_img - 1)
        grid = torch.arange(CROP, dtype=boxes2d.dtype,
                            device=boxes2d.device) + 0.5
        yi = (y1[..., None] + grid * size[..., None] / CROP).to(
            torch.int32).clamp(0, h_img - 1).long()
        xi = (x1[..., None] + grid * size[..., None] / CROP).to(
            torch.int32).clamp(0, w_img - 1).long()
        cam = torch.arange(images.shape[0], device=images.device)
        return images[cam[:, None, None, None], yi[..., :, None],
                      xi[..., None, :]]

    def relabel(self, boxes3d, lidar2image, images):
        """boxes3d (N, 7); images (NCAM, H, W, 3) float in [0, 1].
        Returns (labels (N,) 1-indexed, scores (N,))."""
        self._load()
        boxes2d, visible = project_boxes_to_cameras(
            boxes3d, lidar2image, self.image_size)
        crops = self.crop_boxes(images, boxes2d)
        ncam, n = visible.shape
        mean = torch.tensor(CLIP_MEAN, dtype=crops.dtype, device=crops.device)
        std = torch.tensor(CLIP_STD, dtype=crops.dtype, device=crops.device)
        pix = ((crops - mean) / std).reshape(-1, CROP, CROP, 3).permute(
            0, 3, 1, 2)
        feats = self._model.get_image_features(pixel_values=pix)
        feats = feats / feats.norm(dim=-1, keepdim=True)
        text = self._text_features.to(feats)
        probs = torch.softmax(100.0 * feats @ text.T, dim=-1)
        return camera_mean(probs.reshape(ncam, n, -1), visible)
