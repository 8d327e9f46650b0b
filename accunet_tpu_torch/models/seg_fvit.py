"""SegViT_fKAN, an R50-ViT encoder with fKAN MLPs and a 2-D UNETR decoder
(torch.nn, NHWC): counterpart of accunet_tpu/models/seg_fvit.py.

    hybrid_model: TransUNet's ResNetV2 (models/transunet.py) on the image
        (one channel repeated to three): features at S / 16 and the skips
        at S / 8, S / 4, S / 2 (512, 256, 64 channels)
    patch_embeddings (1x1) + position_embeddings (zero at init, sized from
        the token grid), num_layers ViTBlocks with the fKAN MLP, LayerNorm;
        tokens_to_map, a 3x3 conv to feat_size[3]
    res_proj: 1x1 convs of the three skips to feat_size[0..2]
    encoder1 (on the raw input, its own channel count), encoder2-4 (on the
        projected skips), encoder5 (on the bottleneck): UnetrBasicBlocks
    the skips resized bilinearly (align_corners=False; at 224 encoder4's
        112 x 112 goes down 4x to 28 x 28 with two taps and no antialias,
        encoder2's 28 x 28 up 4x to 112 x 112) to 2, 4, 8, 16 x the
        bottleneck's side; decoder5-2 UnetrUpBlocks, decoder1, a 1x1 head:
        raw logits (trained with binary Dice + BCE)

It takes `in_chans` / `out_chans`, as JAX's builds it. `img_size` sizes the
position embeddings, which JAX takes from the input at init: the CLIs pass
the image size (models/__init__.py `build`'s input_size). Under
dtype=torch.bfloat16 the ResNetV2 body computes in fp32 behind its fp32
GroupNorms, as in JAX, and everything after it in bf16. No hand-written
kernel runs on this model's path.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from accunet_tpu_torch.models.transunet import SKIPS, ResNetV2, ViTBlock, hybrid_grid
from accunet_tpu_torch.nn.unetr import UnetOutBlock, UnetrBasicBlock, UnetrUpBlock
from accunet_tpu_torch.nn.unext_blocks import LayerNorm
from accunet_tpu_torch.ops.conv import conv1x1, conv2d
from accunet_tpu_torch.ops.resize import resize_bilinear


class SegViTfKAN(nn.Module):
    """x (B, S, S, in_chans) -> float32 logits (B, S, S, out_chans); S =
    img_size, divisible by 16."""

    def __init__(self, in_chans: int = 1, out_chans: int = 1, img_size: int = 224,
                 feat_size: Sequence[int] = (64, 128, 256, 512), hidden: int = 768,
                 num_layers: int = 12, heads: int = 12, mlp_dim: int = 3072,
                 dtype: torch.dtype | None = None):
        super().__init__()
        f = feat_size
        self.dtype = dtype
        self.hybrid_model = ResNetV2(in_channels=3 if in_chans == 1 else in_chans)
        self.patch_embeddings = nn.Conv2d(1024, hidden, 1)
        self.position_embeddings = nn.Parameter(torch.zeros(1, hybrid_grid(img_size) ** 2,
                                                            hidden))
        self.layer = nn.ModuleList(ViTBlock(hidden, heads, mlp_dim, "fkan")
                                   for _ in range(num_layers))
        self.encoder_norm = LayerNorm(hidden, eps=1e-6)
        self.tokens_to_map = nn.Conv2d(hidden, f[3], 3, padding=1)
        self.res_proj = nn.ModuleList(nn.Conv2d(c, f[i], 1) for i, c in enumerate(SKIPS))
        self.encoder1 = UnetrBasicBlock(in_chans, f[0])
        self.encoder2 = UnetrBasicBlock(f[0], f[1])
        self.encoder3 = UnetrBasicBlock(f[1], f[2])
        self.encoder4 = UnetrBasicBlock(f[2], f[3])
        self.encoder5 = UnetrBasicBlock(f[3], f[3])
        self.decoder5 = UnetrUpBlock(f[3], f[3])
        self.decoder4 = UnetrUpBlock(f[3], f[2])
        self.decoder3 = UnetrUpBlock(f[2], f[1])
        self.decoder2 = UnetrUpBlock(f[1], f[0])
        self.decoder1 = UnetrBasicBlock(f[0], f[0])
        self.out = UnetOutBlock(f[0], out_chans)

    def forward(self, x_in: torch.Tensor) -> torch.Tensor:
        ct = self.out.conv.weight.dtype if self.dtype is None else self.dtype
        x_in = x_in.to(ct)
        x = x_in.expand(*x_in.shape[:-1], 3) if x_in.shape[-1] == 1 else x_in
        feat, res_features = self.hybrid_model(x)
        p = self.patch_embeddings
        tok_map = conv1x1(feat.to(ct), p.weight, p.bias)
        b, h, w, c = tok_map.shape
        tok = tok_map.flatten(1, 2) + self.position_embeddings.to(ct)
        for layer in self.layer:
            tok = layer(tok)
        tok = self.encoder_norm(tok)
        t = self.tokens_to_map
        x_bottleneck = conv2d(tok.reshape(b, h, w, c), t.weight, t.bias)
        f1, f2, f3 = (conv1x1(r.to(ct), p.weight, p.bias)
                      for p, r in zip(self.res_proj, res_features))

        enc1 = self.encoder1(x_in)
        enc2 = self.encoder2(f1)
        enc3 = self.encoder3(f2)
        enc4 = self.encoder4(f3)
        enc_hidden = self.encoder5(x_bottleneck)
        h0, w0 = enc_hidden.shape[1:3]
        enc4 = resize_bilinear(enc4, (2 * h0, 2 * w0))
        enc3 = resize_bilinear(enc3, (4 * h0, 4 * w0))
        enc2 = resize_bilinear(enc2, (8 * h0, 8 * w0))
        enc1 = resize_bilinear(enc1, (16 * h0, 16 * w0))

        dec3 = self.decoder5(enc_hidden, enc4)
        dec2 = self.decoder4(dec3, enc3)
        dec1 = self.decoder3(dec2, enc2)
        dec0 = self.decoder2(dec1, enc1)
        return self.out(self.decoder1(dec0)).float()
