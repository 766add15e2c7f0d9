"""The ported image backbones and necks by their yaml NAME (the JAX
package's registries; MaskCLIP is built by the open-vocabulary code)."""

from .fpn import GeneralizedLSSFPN
from .resnet import CLIPResNet, ResNet18
from .swin import SwinTransformer

IMAGE_BACKBONE_REGISTRY = {
    "SwinTransformer": SwinTransformer,
    "ResNet18": ResNet18,
    "CLIPResNet": CLIPResNet,
}

NECK_REGISTRY = {"GeneralizedLSSFPN": GeneralizedLSSFPN}
