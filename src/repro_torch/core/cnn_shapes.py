"""CNN layer -> im2col GEMM shapes (M, N, T) for the paper's benchmarks.

Convention (paper §II): X[T,M] = A[T,N] x B[N,M] where for a conv layer
  M = C_out,  N = kh*kw*C_in,  T = H_out*W_out   (batch 1 inference).

Anchors from the paper (§III-C): ResNet-34 layer 20 -> (256, 2304, 196) and
layer 28 -> (512, 2304, 49); tests pin these.

Depthwise convolutions (MobileNet, ConvNeXt) do not map to a single dense
GEMM; following the paper's "everything is GEMM" mapping we model them as a
channel-batched GEMM with N = kh*kw and T = spatial*C (executed per channel
group on the SA) — a small fraction of total time either way.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ConvLayer:
    name: str
    M: int
    N: int
    T: int

    @property
    def mnt(self):
        return (self.M, self.N, self.T)


def _conv(name, c_out, c_in, k, out_hw):
    return ConvLayer(name, c_out, k * k * c_in, out_hw * out_hw)


def _dw(name, c, k, out_hw):
    # depthwise: channel-batched GEMM (see module docstring)
    return ConvLayer(name, c, k * k, out_hw * out_hw)


def _fc(name, c_out, c_in):
    return ConvLayer(name, c_out, c_in, 1)


def resnet34_layers():
    """The 33 conv layers + final fc of ResNet-34 at 224x224."""
    ls = [_conv("conv1", 64, 3, 7, 112)]
    # conv2_x: 3 blocks x 2 convs @ 56, 64ch
    for i in range(6):
        ls.append(_conv(f"conv2_{i}", 64, 64, 3, 56))
    # conv3_x: 4 blocks x 2 convs @ 28, 128ch (first takes 64ch)
    ls.append(_conv("conv3_0", 128, 64, 3, 28))
    for i in range(1, 8):
        ls.append(_conv(f"conv3_{i}", 128, 128, 3, 28))
    # conv4_x: 6 blocks x 2 convs @ 14, 256ch
    ls.append(_conv("conv4_0", 256, 128, 3, 14))
    for i in range(1, 12):
        ls.append(_conv(f"conv4_{i}", 256, 256, 3, 14))
    # conv5_x: 3 blocks x 2 convs @ 7, 512ch
    ls.append(_conv("conv5_0", 512, 256, 3, 7))
    for i in range(1, 6):
        ls.append(_conv(f"conv5_{i}", 512, 512, 3, 7))
    ls.append(_fc("fc", 1000, 512))
    return ls


def mobilenet_layers():
    """MobileNet-v1 (224x224, alpha=1): standard + 13x(dw,pw) + fc."""
    ls = [_conv("conv0", 32, 3, 3, 112)]
    spec = [  # (c_in, c_out, out_hw after this block's dw stride)
        (32, 64, 112), (64, 128, 56), (128, 128, 56), (128, 256, 28),
        (256, 256, 28), (256, 512, 14), (512, 512, 14), (512, 512, 14),
        (512, 512, 14), (512, 512, 14), (512, 512, 14), (512, 1024, 7),
        (1024, 1024, 7),
    ]
    for i, (cin, cout, hw) in enumerate(spec):
        ls.append(_dw(f"dw{i}", cin, 3, hw))
        ls.append(_conv(f"pw{i}", cout, cin, 1, hw))
    ls.append(_fc("fc", 1000, 1024))
    return ls


def convnext_layers():
    """ConvNeXt-T (224x224): stem + stages [3,3,9,3] x (dw7x7, pw, pw)."""
    ls = [_conv("stem", 96, 3, 4, 56)]
    dims = [96, 192, 384, 768]
    depths = [3, 3, 9, 3]
    hws = [56, 28, 14, 7]
    for s, (dim, depth, hw) in enumerate(zip(dims, depths, hws)):
        if s > 0:
            ls.append(_conv(f"ds{s}", dim, dims[s - 1], 2, hw))
        for b in range(depth):
            ls.append(_dw(f"s{s}b{b}_dw", dim, 7, hw))
            ls.append(_conv(f"s{s}b{b}_pw1", 4 * dim, dim, 1, hw))
            ls.append(_conv(f"s{s}b{b}_pw2", dim, 4 * dim, 1, hw))
    ls.append(_fc("head", 1000, 768))
    return ls


NETWORKS = {
    "resnet34": resnet34_layers,
    "mobilenet": mobilenet_layers,
    "convnext": convnext_layers,
}


def network_mnt(name: str):
    return [l.mnt for l in NETWORKS[name]()]
