"""MaskCLIP — per-pixel CLIP class probabilities from dense image
features (the value-embedding trick) — port of findnpropagate_tpu/models/
backbones_image/maskclip.py.

`pixel_probs` normalises the dense features, takes their logits against
the class text features at the CLIP logit scale, softmaxes over the
classes and resizes bilinearly to the image (half-pixel centres, as
jax.image.resize's "bilinear" upsampling). The encoder is two attributes a
caller can set: `_encode_dense` ((B, H, W, 3) images in [0, 1] -> (B, h, w,
E) patch features) and `_text_features` ((C, E), normalised). Left unset,
`_load` builds them from the `transformers` package's CLIPModel; that
needs the package and the model's weights on disk, and it raises naming
both when either is missing.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


class MaskCLIP:
    """Dense CLIP feature extractor and per-pixel class probabilities."""

    def __init__(self, class_names: Sequence[str],
                 model_name: str = "openai/clip-vit-base-patch32",
                 logit_scale: float = 100.0):
        self.class_names = list(class_names)
        self.model_name = model_name
        self.logit_scale = logit_scale
        self._encode_dense = None     # (B,H,W,3) -> (B,h,w,E) patch feats
        self._text_features = None    # (C, E) normalised

    def _load(self):
        if self._encode_dense is not None and \
                self._text_features is not None:
            return
        try:
            from transformers import CLIPModel, CLIPTokenizer
            model = CLIPModel.from_pretrained(self.model_name,
                                              local_files_only=True)
            tokenizer = CLIPTokenizer.from_pretrained(
                self.model_name, local_files_only=True)
        except (ImportError, OSError) as e:
            raise RuntimeError(
                f"MaskCLIP needs the `transformers` package and the weights "
                f"and vocabulary of {self.model_name!r} on disk; set "
                "`_encode_dense` and `_text_features` to use another "
                f"encoder ({type(e).__name__}: {e})") from e
        model.eval()
        prompts = [f"a photo of a {n.replace('_', ' ')}"
                   for n in self.class_names]
        with torch.no_grad():
            tf = model.get_text_features(
                **tokenizer(prompts, return_tensors="pt", padding=True))
        self._text_features = tf / tf.norm(dim=-1, keepdim=True)

        def encode(images):
            # the vision tower's patch tokens through the final projection
            pix = images.permute(0, 3, 1, 2)
            with torch.no_grad():
                tokens = model.vision_model(
                    pixel_values=pix).last_hidden_state[:, 1:]
                tokens = model.visual_projection(tokens)     # (B, P, E)
            b, p, e = tokens.shape
            g = int(round(p ** 0.5))
            return tokens.reshape(b, g, g, e)

        self._encode_dense = encode

    def pixel_probs(self, images):
        """(B, H, W, 3) -> (B, H, W, C) per-pixel class probabilities."""
        self._load()
        feats = self._encode_dense(images)               # (B, h, w, E)
        feats = feats / (feats.norm(dim=-1, keepdim=True) + 1e-8)
        text = self._text_features.to(feats)
        logits = self.logit_scale * torch.einsum("bhwe,ce->bchw", feats,
                                                 text)
        probs = torch.softmax(logits, dim=1)
        out = F.interpolate(probs, size=tuple(images.shape[1:3]),
                            mode="bilinear", align_corners=False)
        return out.permute(0, 2, 3, 1)
