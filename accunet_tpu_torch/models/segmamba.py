"""The SegMamba family in torch.nn on NHWC tensors: counterpart of
accunet_tpu/models/segmamba.py (`GSC`, `TokenMLP`, `SimpleTokenMLP`,
`ConvKANFFN2D`, `WindowTokenAttention`, `TokenVSSM`, `TransformerMambaBlock`,
`PlainMambaLayer`, `MlpChannel`, `MambaEncoder`, `SegMamba`, `VARIANTS`,
`build_segmamba`).

    encoder "vit": stem 7x7/2 conv, then per stage (IN + 2x2/2 conv from
        stage 1 on) -> [GSC] -> depths[i] blocks: PlainMambaLayers (token
        LayerNorm + BiMamba + residual; the baseline), SpatialMambaBlocks
        (block "spatial", or "spatial_kan" with the KAN FFN) or hybrid
        TransformerMambaBlocks (block "tmb") -> [IN + MlpChannel (1x1 conv,
        GELU, 1x1 conv)]
    UNETR decoder: encoder1..5 UnetrBasicBlocks on the input and the four
        stage outputs, each skip [fused with the text], decoder5..2
        UnetrUpBlocks, decoder1, [the final refine over its tokens: FKANMLP
        or, for "simple_mlp", SimpleTokenMLP], UnetOutBlock
    -> float32 logits (B, H, W, out_chans), or with deep supervision and
       ds_in_output the tuple (main, ds1, ds2, ds3) of the main head and the
       1x1 heads on decoder3, 4 and 5, resized bilinearly (align_corners
       False) to the main head's size

TransformerMambaBlock on (B, H, W, C) as tokens t, over the reference's
ablation axes (attn_type mdta | window, ffn1_type fkan | simple_mlp,
ffn2_type fkan | token_mlp | simple_mlp | effkan | cab, mixer_type mamba |
ss2d, spatial_fusion, flip_order, inner_residuals):

    attention half: a = attn(ln1(t)) + t; u = ffn1(ln2(a)) [+ a]
    mamba half:     m = mixer(ln3(t)) + t; n = ffn2(ln4(m)) [+ m]
                    (cab: n = CAB(m) + m, no ln4)
    out = x + u + n', the halves in order (flip_order: mamba half first),
    the second on x + the first's output

Text fusion (text_fusion hslca | tgdc | film | crossattn | dual) runs on
the four encoder skips and, for hslca and dual unless text_fusion_hidden
says otherwise, on the bottleneck; dual threads its updated text from site
to site. `forward(x, text_tokens)` with text_tokens None (or text_fusion
None) fuses nothing, as in JAX.

Every BiMamba runs two selective scans (forward and time-flipped), every
MambaVisionMixer one (d_state 8, no z), every TokenVSSM's SS2D four, each
one fused kernel forward and one backward; every SpatialMambaBlock one
return-hidden scan.

The defaults are the baseline's (block "plain", no GSC, stage MLPs, no
text fusion, refine or deep supervision); JAX's are the flagship's, so each
VARIANTS entry here spells out every axis.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from accunet_tpu_torch.models.swin_unet import WindowAttention, window_partition, window_reverse
from accunet_tpu_torch.nn.attention import (
    CAB,
    CrossAttentionFusion,
    DualCrossAttentionFusion,
    HSLCAFusion,
    SkipFiLM,
    TGDCFusion,
    TokenMDTA,
)
from accunet_tpu_torch.nn.kan import FKANMLP, KAN
from accunet_tpu_torch.nn.ss2d import SS2D
from accunet_tpu_torch.nn.ssm import BiMamba, MambaVisionMixer, SpatialMambaBlock
from accunet_tpu_torch.nn.unetr import (
    UnetOutBlock,
    UnetrBasicBlock,
    UnetrUpBlock,
    instance_norm,
)
from accunet_tpu_torch.ops.conv import conv1x1, conv2d, conv2d_strided
from accunet_tpu_torch.ops.resize import resize_bilinear


def _square(n: int) -> int:
    hw = round(n ** 0.5)
    assert hw * hw == n, "token count must be a perfect square"
    return hw


class GSC(nn.Module):
    """Gated spatial conv block: x1 = relu(IN(proj2(relu(IN(proj(x)))))),
    x2 = relu(IN(proj3(x))), out = relu(IN(proj4(x1 + x2))) + x; proj and
    proj2 3x3, proj3 and proj4 1x1, all with bias."""

    def __init__(self, channels: int):
        super().__init__()
        c = channels
        self.proj = nn.Conv2d(c, c, 3)
        self.proj2 = nn.Conv2d(c, c, 3)
        self.proj3 = nn.Conv2d(c, c, 1)
        self.proj4 = nn.Conv2d(c, c, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def block(conv, y):
            return F.relu(instance_norm(conv2d(y, conv.weight, conv.bias)))

        x1 = block(self.proj2, block(self.proj, x))
        x2 = block(self.proj3, x)
        return block(self.proj4, x1 + x2) + x


class TokenMLP(nn.Module):
    """fc1 -> exact GELU -> fc2 over tokens, no norm."""

    def __init__(self, dim: int, mlp_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, mlp_dim)
        self.fc2 = nn.Linear(mlp_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class SimpleTokenMLP(TokenMLP):
    """LayerNorm, then TokenMLP."""

    def __init__(self, dim: int, mlp_dim: int):
        super().__init__(dim, mlp_dim)
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(self.norm(x))


class ConvKANFFN2D(nn.Module):
    """Efficient-KAN FFN on square tokens (B, N, C): 3x3 conv, GELU, 3x3
    conv, GELU -> LayerNorm (r) -> KAN -> 3x3 depthwise, GELU -> KAN -> 3x3
    depthwise, GELU, + r."""

    def __init__(self, dim: int, mlp_dim: int):
        super().__init__()
        c = dim
        self.conv1 = nn.Conv2d(c, c, 3)
        self.conv2 = nn.Conv2d(c, c, 3)
        self.post_conv_ln = nn.LayerNorm(c, eps=1e-5)
        self.kan1 = KAN((c, mlp_dim, c))
        self.dwconv1 = nn.Conv2d(c, c, 3, groups=c)
        self.kan2 = KAN((c, mlp_dim, c))
        self.dwconv2 = nn.Conv2d(c, c, 3, groups=c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        hw = _square(n)

        def conv(m, t, groups=1):
            y = conv2d(t.reshape(b, hw, hw, c), m.weight, m.bias, groups=groups)
            return F.gelu(y).reshape(b, n, c)

        y = self.post_conv_ln(conv(self.conv2, conv(self.conv1, x)))
        res = y
        y = conv(self.dwconv1, self.kan1(y.reshape(b * n, c)), groups=c)
        y = conv(self.dwconv2, self.kan2(y.reshape(b * n, c)), groups=c)
        return y + res


class WindowTokenAttention(nn.Module):
    """Swin window attention (no shift) over square tokens (B, N, C); the
    side must divide by the window."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7):
        super().__init__()
        self.window_size = window_size
        self.inner = WindowAttention(dim, window_size, num_heads)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        hw, ws = _square(n), self.window_size
        wins = self.inner(window_partition(x.reshape(b, hw, hw, c), ws))
        return window_reverse(wins, ws, hw, hw).reshape(b, n, c)


class TokenVSSM(nn.Module):
    """VSSMBlock on square tokens (B, N, C): top Linear -> 3x3 depthwise ->
    SiLU -> SS2D -> LayerNorm, bottom Linear -> SiLU, concatenated ->
    Linear."""

    def __init__(self, dim: int, d_state: int = 8):
        super().__init__()
        c = dim
        self.top_linear = nn.Linear(c, c)
        self.top_dwconv = nn.Conv2d(c, c, 3, groups=c)
        self.top_ssm = SS2D(c, d_state=d_state)
        self.top_norm = nn.LayerNorm(c, eps=1e-6)
        self.bottom_linear = nn.Linear(c, c)
        self.out_linear = nn.Linear(2 * c, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        hw = _square(n)
        x2d = x.reshape(b, hw, hw, c)
        t = conv2d(self.top_linear(x2d), self.top_dwconv.weight, self.top_dwconv.bias, groups=c)
        t = self.top_norm(self.top_ssm(F.silu(t)))
        bot = F.silu(self.bottom_linear(x2d))
        return self.out_linear(torch.cat([t, bot], dim=-1)).reshape(b, n, c)


FFN_KINDS = {"fkan": FKANMLP, "token_mlp": TokenMLP, "simple_mlp": SimpleTokenMLP,
             "effkan": ConvKANFFN2D}


def _make_ffn(kind: str, dim: int, mlp_dim: int) -> nn.Module:
    if kind not in FFN_KINDS:
        raise ValueError(f"unknown ffn kind {kind!r}")
    return FFN_KINDS[kind](dim, mlp_dim)


class TransformerMambaBlock(nn.Module):
    """The double-residual hybrid block on (B, H, W, C) (module docstring)."""

    def __init__(self, dim: int, num_heads: int = 4, mlp_ratio: float = 4.0, d_state: int = 8,
                 d_conv: int = 3, expand: int = 1, attn_type: str = "mdta",
                 ffn1_type: str = "fkan", ffn2_type: str = "fkan", mixer_type: str = "mamba",
                 spatial_fusion: bool = False, flip_order: bool = False,
                 inner_residuals: bool = True):
        super().__init__()
        c, mlp_dim = dim, int(dim * mlp_ratio)
        self.attn_type, self.ffn1_type, self.ffn2_type = attn_type, ffn1_type, ffn2_type
        self.mixer_type, self.spatial_fusion = mixer_type, spatial_fusion
        self.flip_order, self.inner_residuals = flip_order, inner_residuals
        if attn_type == "window":
            self.attn = WindowTokenAttention(c, num_heads)
        elif attn_type == "mdta":
            self.attn = TokenMDTA(c, num_heads)
        else:
            raise ValueError(f"unknown attn_type {attn_type!r}")
        self.ffn1 = _make_ffn(ffn1_type, c, mlp_dim)
        if mixer_type == "ss2d":
            self.vssm = TokenVSSM(c, d_state)
        elif mixer_type == "mamba":
            self.vssm = MambaVisionMixer(c, d_state, d_conv, expand, spatial_fusion=spatial_fusion)
        else:
            raise ValueError(f"unknown mixer_type {mixer_type!r}")
        self.ln1 = nn.LayerNorm(c, eps=1e-5)
        self.ln2 = nn.LayerNorm(c, eps=1e-5)
        self.ln3 = nn.LayerNorm(c, eps=1e-5)
        if ffn2_type == "cab":
            self.cab = CAB(c)
        else:
            self.ln4 = nn.LayerNorm(c, eps=1e-5)
            self.ffn2 = _make_ffn(ffn2_type, c, mlp_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        x_in = x.reshape(b, h * w, c)

        def attn_half(t):
            a = self.attn(self.ln1(t)) + t
            u = self.ffn1(self.ln2(a))
            return u + a if self.inner_residuals else u

        def mamba_half(t):
            if self.mixer_type == "ss2d":
                m = self.vssm(self.ln3(t)) + t
            else:
                m = self.vssm(self.ln3(t), spatial_hw=(h, w)) + t
            if self.ffn2_type == "cab":
                return self.cab(m.reshape(b, h, w, c)).reshape(b, h * w, c) + m
            n = self.ffn2(self.ln4(m))
            return n + m if self.inner_residuals else n

        first, second = (mamba_half, attn_half) if self.flip_order else (attn_half, mamba_half)
        x_tr = x_in + first(x_in)
        return (x_tr + second(x_tr)).reshape(b, h, w, c)


class PlainMambaLayer(nn.Module):
    """Token LayerNorm + bimamba-v2 mixer + residual on (B, H, W, C)."""

    def __init__(self, dim: int, d_state: int = 16, d_conv: int = 4, expand: int = 2):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.mamba = BiMamba(dim, d_state, d_conv, expand)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        t = x.reshape(b, h * w, c)
        return (t + self.mamba(self.norm(t))).reshape(b, h, w, c)


class MlpChannel(nn.Module):
    """1x1 conv -> exact GELU -> 1x1 conv."""

    def __init__(self, hidden_size: int, mlp_dim: int):
        super().__init__()
        self.fc1 = nn.Conv2d(hidden_size, mlp_dim, 1)
        self.fc2 = nn.Conv2d(mlp_dim, hidden_size, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.gelu(conv1x1(x, self.fc1.weight, self.fc1.bias))
        return conv1x1(y, self.fc2.weight, self.fc2.bias)


class MambaEncoder(nn.Module):
    def __init__(self, in_chans: int = 1, depths: Sequence[int] = (2, 2, 2, 2),
                 dims: Sequence[int] = (48, 96, 192, 384), block: str = "plain",
                 block_kwargs: dict | None = None, use_gsc: bool = False,
                 stage_mlp: bool = True):
        super().__init__()
        bkw = dict(block_kwargs or {})  # the TransformerMambaBlock's axes
        blocks = {"plain": PlainMambaLayer, "spatial": SpatialMambaBlock,
                  "spatial_kan": lambda c: SpatialMambaBlock(c, mlp_type="kan"),
                  "tmb": lambda c: TransformerMambaBlock(c, **bkw)}
        if block not in blocks:
            raise ValueError(f"unknown MambaEncoder block {block!r}")
        self.stem = nn.Conv2d(in_chans, dims[0], 7, stride=2, padding=3)
        self.downsample = nn.ModuleDict(
            {str(i): nn.Conv2d(dims[i - 1], dims[i], 2, stride=2) for i in range(1, 4)})
        self.gscs = nn.ModuleList(GSC(dims[i]) for i in range(4)) if use_gsc else None
        self.stages = nn.ModuleList(
            nn.ModuleList(blocks[block](dims[i]) for _ in range(depths[i])) for i in range(4))
        self.mlps = (nn.ModuleList(MlpChannel(dims[i], 2 * dims[i]) for i in range(4))
                     if stage_mlp else None)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        outs = []
        for i in range(4):
            if i == 0:
                conv = self.stem
            else:
                conv, x = self.downsample[str(i)], instance_norm(x)
            x = conv2d_strided(x, conv.weight, conv.bias, conv.stride, conv.padding)
            if self.gscs is not None:
                x = self.gscs[i](x)
            for layer in self.stages[i]:
                x = layer(x)
            if self.mlps is not None:
                x = self.mlps[i](instance_norm(x))
            outs.append(x)
        return tuple(outs)


FUSIONS = {"hslca": HSLCAFusion, "tgdc": TGDCFusion, "film": SkipFiLM,
           "crossattn": CrossAttentionFusion, "dual": DualCrossAttentionFusion}
# the attribute prefix of each fusion's sites (1-4, then _hidden), as in JAX
FUSION_PREFIX = {"hslca": "hslca", "tgdc": "tgdc", "film": "skip_film",
                 "crossattn": "cross_attn", "dual": "dual_ca"}


class SegMamba(nn.Module):
    def __init__(self, in_chans: int = 1, out_chans: int = 1,
                 depths: Sequence[int] = (2, 2, 2, 2),
                 feat_size: Sequence[int] = (48, 96, 192, 384), hidden_size: int = 768,
                 block: str = "plain", block_kwargs: dict | None = None,
                 use_gsc: bool = False, stage_mlp: bool = True,
                 text_fusion: str | None = None, text_fusion_hidden: bool | None = None,
                 deep_supervision: bool = False, final_refine: str | None = None,
                 ds_in_output: bool = False):
        super().__init__()
        if text_fusion is not None and text_fusion not in FUSIONS:
            raise ValueError(f"unknown text_fusion {text_fusion!r}")
        refines = {None: None, "fkan": FKANMLP, "simple_mlp": SimpleTokenMLP}
        if final_refine not in refines:
            raise ValueError(f"unknown final_refine {final_refine!r}")
        f = list(feat_size)
        self.text_fusion = text_fusion
        self.ds_in_output = deep_supervision and ds_in_output
        self.vit = MambaEncoder(in_chans, depths, f, block, block_kwargs, use_gsc, stage_mlp)
        self.encoder1 = UnetrBasicBlock(in_chans, f[0])
        self.encoder2 = UnetrBasicBlock(f[0], f[1])
        self.encoder3 = UnetrBasicBlock(f[1], f[2])
        self.encoder4 = UnetrBasicBlock(f[2], f[3])
        self.encoder5 = UnetrBasicBlock(f[3], hidden_size)
        # the fusion sites: the four skips and, for hslca and dual by
        # default, the bottleneck
        self.fusion_sites = []
        if text_fusion is not None:
            fuse_hidden = (text_fusion in ("hslca", "dual") if text_fusion_hidden is None
                           else text_fusion_hidden)
            sites = [("1", f[0]), ("2", f[1]), ("3", f[2]), ("4", f[3])]
            for idx, dim in sites + ([("_hidden", hidden_size)] if fuse_hidden else []):
                name = FUSION_PREFIX[text_fusion] + idx
                setattr(self, name, FUSIONS[text_fusion](dim))
                self.fusion_sites.append(name)
        self.decoder5 = UnetrUpBlock(hidden_size, f[3])
        self.decoder4 = UnetrUpBlock(f[3], f[2])
        self.decoder3 = UnetrUpBlock(f[2], f[1])
        self.decoder2 = UnetrUpBlock(f[1], f[0])
        self.decoder1 = UnetrBasicBlock(f[0], f[0])
        refine = refines[final_refine]
        self.final_refine_kan_mlp = refine(f[0], 4 * f[0]) if refine else None
        self.out = UnetOutBlock(f[0], out_chans)
        if deep_supervision:  # the heads exist even where only the main head is returned
            self.ds_head3 = UnetOutBlock(f[3], out_chans)
            self.ds_head2 = UnetOutBlock(f[2], out_chans)
            self.ds_head1 = UnetOutBlock(f[1], out_chans)

    def forward(self, x: torch.Tensor, text_tokens: torch.Tensor | None = None):
        """x (B, H, W, in_chans), H and W divisible by 16, and the text
        tokens (B, T, 768) or None -> float32 logits (B, H, W, out_chans),
        or the tuple (main, ds1, ds2, ds3) of such."""
        x = x.to(self.out.conv.weight.dtype)
        text = None if text_tokens is None else text_tokens.to(x.dtype)
        outs = self.vit(x)
        skips = [self.encoder1(x), self.encoder2(outs[0]), self.encoder3(outs[1]),
                 self.encoder4(outs[2]), self.encoder5(outs[3])]
        if text is not None:
            for i, name in enumerate(self.fusion_sites):  # the sites in order
                fused = getattr(self, name)(skips[i], text)
                if self.text_fusion == "dual":  # the updated text goes on
                    fused, text = fused
                skips[i] = fused
        enc1, enc2, enc3, enc4, enc_hidden = skips
        dec3 = self.decoder5(enc_hidden, enc4)
        dec2 = self.decoder4(dec3, enc3)
        dec1 = self.decoder3(dec2, enc2)
        dec0 = self.decoder2(dec1, enc1)
        out = self.decoder1(dec0)
        if self.final_refine_kan_mlp is not None:
            b, h, w, c = out.shape
            out = self.final_refine_kan_mlp(out.reshape(b, h * w, c)).reshape(b, h, w, c)
        out_main = self.out(out)
        if not self.ds_in_output:
            return out_main.float()
        target = tuple(out_main.shape[1:3])
        heads = [resize_bilinear(head(dec), target).float()
                 for head, dec in ((self.ds_head1, dec1), (self.ds_head2, dec2),
                                   (self.ds_head3, dec3))]
        return (out_main.float(), *heads)


def _variant(block, block_kwargs=None, use_gsc=True, stage_mlp=False, text_fusion=None,
             text_fusion_hidden=None, deep_supervision=True, final_refine="fkan",
             ds_in_output=False):
    """Every axis of a VARIANTS entry; the defaults here are JAX's, except
    text_fusion (set by each entry that has it)."""
    return dict(block=block, block_kwargs=block_kwargs, use_gsc=use_gsc, stage_mlp=stage_mlp,
                text_fusion=text_fusion, text_fusion_hidden=text_fusion_hidden,
                deep_supervision=deep_supervision, final_refine=final_refine,
                ds_in_output=ds_in_output)


_NO_EXTRAS = dict(text_fusion=None, deep_supervision=False, final_refine=None)

# registry name -> constructor kwargs: the model of the JAX package's VARIANTS
# entry, with every axis spelt out (the defaults of SegMamba here are the
# baseline's, JAX's the flagship's)
VARIANTS = {
    "Segmamba": _variant("plain", use_gsc=False, stage_mlp=True, **_NO_EXTRAS),
    "Segmamba_hybrid": _variant("tmb", dict(inner_residuals=False), use_gsc=False,
                                **_NO_EXTRAS),
    "Segmamba_hybrid_gsc": _variant("tmb", **_NO_EXTRAS),
    "Segmamba_hybrid_gsc_CA": _variant("tmb", dict(ffn2_type="cab"), **_NO_EXTRAS),
    "Segmamba_hybrid_gsc_SWAttn": _variant("tmb", dict(attn_type="window"), **_NO_EXTRAS),
    "Segmamba_hybrid_gsc_VSS": _variant("tmb", dict(mixer_type="ss2d"), **_NO_EXTRAS),
    "Segmamba_hybrid_gsc_rm_fkan": _variant("tmb", dict(ffn2_type="token_mlp"), **_NO_EXTRAS),
    "Segmamba_hybrid_gsc_ds": _variant("tmb", final_refine=None, ds_in_output=True),
    "Segmamba_hybrid_gsc_KAN_PE": _variant("tmb", deep_supervision=False),
    "Segmamba_hybrid_gsc_KAN_PE_rm_fkan": _variant("tmb", dict(ffn2_type="token_mlp"),
                                                   deep_supervision=False),
    "Segmamba_hybrid_gsc_KAN_PE_rm_fkan_ds": _variant("tmb", dict(ffn2_type="token_mlp"),
                                                      ds_in_output=True),
    "segmamba_hybrid_gsc_KAN_PE_EffKan": _variant("tmb", dict(ffn2_type="effkan"),
                                                  deep_supervision=False),
    "Segmamba_hybrid_gsc_KAN_PE_ds": _variant("tmb"),
    "Segmamba_hybrid_gsc_KAN_PE_ds_flip": _variant("tmb", dict(flip_order=True),
                                                   ds_in_output=True),
    "Segmamba_hybrid_gsc_KAN_PE_ds_SPATIAL": _variant("tmb", dict(spatial_fusion=True),
                                                      ds_in_output=True),
    "Segmamba_hybrid_gsc_MLP_PE_ds": _variant(
        "tmb", dict(ffn1_type="simple_mlp", ffn2_type="simple_mlp"), final_refine="simple_mlp"),
    "Segmamba_hybrid_gsc_KAN_PE_ds_text": _variant("tmb", text_fusion="film"),
    "Segmamba_hybrid_gsc_KAN_PE_ds_CrossAttn": _variant("tmb", text_fusion="crossattn"),
    "Segmamba_hybrid_gsc_KAN_PE_ds_CrossAttn_TGDC": _variant("tmb", text_fusion="tgdc"),
    "Segmamba_hybrid_gsc_KAN_PE_ds_CrossAttn_HSLCA": _variant("tmb", text_fusion="hslca",
                                                              ds_in_output=True),
    "Segmamba_hybrid_gsc_KAN_PE_ds_CrossAttn_Dual": _variant("tmb", text_fusion="dual",
                                                             ds_in_output=True),
    "Segmamba_hybrid_gsc_KAN_PE_ds_CrossAttn_SpatialMamba": _variant(
        "spatial", text_fusion="crossattn", ds_in_output=True),
    "Segmamba_hybrid_gsc_KAN_PE_ds_CrossAttn_Dual_SpatialMamba": _variant(
        "spatial", text_fusion="dual", text_fusion_hidden=False, ds_in_output=True),
    "Segmamba_hybrid_gsc_KAN_PE_ds_CrossAttn_HSLCA_SpatialMamba": _variant(
        "spatial", text_fusion="hslca"),
    "Segmamba_hybrid_gsc_KAN_PE_ds_CrossAttn_HSLCA_SpatialMamba_KAN": _variant(
        "spatial_kan", text_fusion="hslca"),
    "Segmamba_hybrid_gsc_KAN_PE_ds_CrossAttn_HSLCA_SpatialMamba_no_text": _variant(
        "spatial", ds_in_output=True),
}


def build_segmamba(name: str, in_chans: int = 1, out_chans: int = 1, **overrides) -> SegMamba:
    kwargs = dict(VARIANTS[name])
    kwargs.update(overrides)
    return SegMamba(in_chans=in_chans, out_chans=out_chans, **kwargs)
