"""The paper's own experiment: MobileNetV2 with GroupNorm for a CIFAR-like
10-class transfer (Dynamic Gradient Sparse Update, Table II).

A copy of the reference package's config. `CONFIG` is the published
MobileNetV2 table (width 1.0, 224 x 224, fp32) with BatchNorm replaced by
GroupNorm (8 groups); `smoke_config()` is its CPU-sized cut. The CNN config
is its own dataclass: conv stacks do not fit `ModelConfig`.
"""
from dataclasses import dataclass
from typing import Sequence


@dataclass(frozen=True)
class MobileNetV2Config:
    name: str = "mobilenetv2-cifar"
    num_classes: int = 10
    width_mult: float = 1.0
    img_size: int = 224
    in_channels: int = 3
    gn_groups: int = 8
    # (expansion t, out channels c, repeats n, stride s): MobileNetV2 table 2
    inverted_residual_setting: Sequence[tuple] = (
        (1, 16, 1, 1),
        (6, 24, 2, 2),
        (6, 32, 3, 2),
        (6, 64, 4, 2),
        (6, 96, 3, 1),
        (6, 160, 3, 2),
        (6, 320, 1, 1),
    )
    stem_channels: int = 32
    head_channels: int = 1280
    dtype: str = "float32"


CONFIG = MobileNetV2Config()


def smoke_config() -> MobileNetV2Config:
    return MobileNetV2Config(
        name="mobilenetv2-smoke",
        num_classes=10,
        width_mult=0.25,
        img_size=32,
        gn_groups=2,
        inverted_residual_setting=(
            (1, 8, 1, 1),
            (6, 16, 2, 2),
            (6, 24, 2, 2),
        ),
        stem_channels=8,
        head_channels=64,
    )
