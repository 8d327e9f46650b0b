"""Attention and text-fusion blocks of the SegMamba hybrid family (NHWC and
token layouts): counterpart of accunet_tpu/nn/attention.py.

    MDTAAttention / TokenMDTA: 1x1 qkv conv + 3x3 depthwise conv; per head
        the L2-normalised q and k attend channel to channel (ch x ch, not
        token to token), scaled by a learnt temperature; 1x1 project_out
    ChannelAttention / CAB: global mean -> 1x1 squeeze -> ReLU -> 1x1 expand
        -> sigmoid scale; CAB puts two 3x3 convs (GELU between) before it
    HSLCA / HSLCAFusion: text -> 4 summary tokens by a softmax over the text
        tokens; linear attention (phi = elu + 1, K^T V first) from the image
        tokens to them; a KAN gate on the mean of the result; LayerNorm
    TorchMultiheadAttention: torch nn.MultiheadAttention's packed in_proj
        and out_proj; CrossAttentionFusion (image <- text) and
        DualCrossAttentionFusion (image <- text, then text <- image, which
        returns the updated text) call it after their own q/k/v Linears, a
        double projection the reference has
    SkipFiLM: x * (1 + gamma(t)) + beta(t) on the mean text token
    TGDC / TGDCFusion: the mean text token -> a softmax over 4 depthwise
        conv1d branches over the tokens; two gated passes with shared
        weights, gamma * LayerNorm, plus the input
    ExternalAttention (SMESwinUnet's skips): mk to S memory slots, a softmax
        over the tokens, each token's slots divided by their sum, mv back

Every fusion returns its input unchanged when the text is None. Attention
here is plain matmul and softmax, as JAX computes it with plain XLA ops.
Parameter names are the flax submodule names (`mlp_0` as `mlp.0`, ...), so
the JAX tree loads with `state_dict_from_jax`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from accunet_tpu_torch.nn.kan import KAN
from accunet_tpu_torch.ops.conv import conv1x1, conv2d, depthwise_conv1d, linear


class ExternalAttention(nn.Module):
    """External attention over tokens (B, N, d_model) with s shared memory
    slots: bias-free mk, a softmax over the token axis, each token's slots
    divided by their sum, bias-free mv."""

    def __init__(self, d_model: int, s: int = 64):
        super().__init__()
        self.mk = nn.Linear(d_model, s, bias=False)
        self.mv = nn.Linear(s, d_model, bias=False)

    def forward(self, queries: torch.Tensor) -> torch.Tensor:
        attn = torch.softmax(linear(queries, self.mk.weight), dim=1)
        return linear(attn / attn.sum(dim=2, keepdim=True), self.mv.weight)


class MDTAAttention(nn.Module):
    """Channel-wise transposed attention over a map (B, H, W, C)."""

    def __init__(self, dim: int, num_heads: int, use_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = nn.Conv2d(dim, 3 * dim, 1, bias=use_bias)
        self.qkv_dwconv = nn.Conv2d(3 * dim, 3 * dim, 3, groups=3 * dim, bias=use_bias)
        self.project_out = nn.Conv2d(dim, dim, 1, bias=use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        heads = self.num_heads
        qkv = conv1x1(x, self.qkv.weight, self.qkv.bias)
        qkv = conv2d(qkv, self.qkv_dwconv.weight, self.qkv_dwconv.bias, groups=3 * c)

        def to_heads(t):  # (B, heads, ch, HW), channel-major
            return t.reshape(b, h * w, heads, c // heads).permute(0, 2, 3, 1)

        q, k, v = map(to_heads, qkv.split(c, dim=-1))
        q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-12)
        k = k / (torch.linalg.vector_norm(k, dim=-1, keepdim=True) + 1e-12)
        attn = torch.softmax(q @ k.transpose(-1, -2) * self.temperature.to(q.dtype), dim=-1)
        out = (attn @ v).permute(0, 3, 1, 2).reshape(b, h, w, c)
        return conv1x1(out, self.project_out.weight, self.project_out.bias)


class TokenMDTA(nn.Module):
    """MDTA over a square token sequence (B, N, C)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.inner = MDTAAttention(dim, num_heads)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        hw = round(n ** 0.5)
        assert hw * hw == n, "token count must be a perfect square"
        return self.inner(x.reshape(b, hw, hw, c)).reshape(b, n, c)


class ChannelAttention(nn.Module):
    def __init__(self, num_feat: int, squeeze_factor: int = 16):
        super().__init__()
        mid = max(1, num_feat // squeeze_factor)
        self.squeeze = nn.Conv2d(num_feat, mid, 1)
        self.expand = nn.Conv2d(mid, num_feat, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(conv1x1(x.mean(dim=(1, 2), keepdim=True), self.squeeze.weight,
                           self.squeeze.bias))
        return x * torch.sigmoid(conv1x1(y, self.expand.weight, self.expand.bias))


class CAB(nn.Module):
    """3x3 conv -> exact GELU -> 3x3 conv -> channel attention."""

    def __init__(self, num_feat: int, compress_ratio: int = 3, squeeze_factor: int = 30):
        super().__init__()
        mid = max(1, num_feat // compress_ratio)
        self.conv1 = nn.Conv2d(num_feat, mid, 3)
        self.conv2 = nn.Conv2d(mid, num_feat, 3)
        self.ca = ChannelAttention(num_feat, squeeze_factor)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.gelu(conv2d(x, self.conv1.weight, self.conv1.bias))
        return self.ca(conv2d(y, self.conv2.weight, self.conv2.bias))


def _split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    b, n, c = t.shape
    return t.reshape(b, n, heads, c // heads).transpose(1, 2)


class HSLCA(nn.Module):
    def __init__(self, dim: int, num_heads: int = 4, num_summary_tokens: int = 4,
                 reduction: int = 4):
        super().__init__()
        self.num_heads = num_heads
        self.summary_proj = nn.Linear(dim, num_summary_tokens)
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)
        self.gate_norm = nn.LayerNorm(dim, eps=1e-5)
        self.gate_kan = KAN((dim, dim // reduction, dim))
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, image_tokens: torch.Tensor, text_tokens: torch.Tensor) -> torch.Tensor:
        b, n, c = image_tokens.shape
        weights = torch.softmax(self.summary_proj(text_tokens), dim=1)  # over the tokens
        summary = weights.transpose(1, 2) @ text_tokens  # (B, K, C)
        q = F.elu(_split_heads(self.q_proj(image_tokens), self.num_heads)) + 1
        k = F.elu(_split_heads(self.k_proj(summary), self.num_heads)) + 1
        v = _split_heads(self.v_proj(summary), self.num_heads)
        attn = (q @ (k.transpose(-1, -2) @ v)).transpose(1, 2).reshape(b, n, c)
        attn = self.out_proj(attn)
        alpha = torch.sigmoid(self.gate_kan(self.gate_norm(attn.mean(dim=1))))[:, None, :]
        return self.norm(image_tokens + alpha * attn)


class HSLCAFusion(nn.Module):
    """Text into an NHWC map through HSLCA over its tokens."""

    def __init__(self, img_dim: int, text_dim: int = 768, num_heads: int = 4,
                 num_summary_tokens: int = 4, reduction: int = 4):
        super().__init__()
        self.text_proj = nn.Linear(text_dim, img_dim)
        self.norm_img = nn.LayerNorm(img_dim, eps=1e-5)
        self.norm_txt = nn.LayerNorm(img_dim, eps=1e-5)
        self.hslca = HSLCA(img_dim, num_heads, num_summary_tokens, reduction)

    def forward(self, x: torch.Tensor, text_tokens: torch.Tensor | None) -> torch.Tensor:
        if text_tokens is None:
            return x
        b, h, w, c = x.shape
        t = self.norm_txt(self.text_proj(text_tokens))
        return self.hslca(self.norm_img(x.reshape(b, h * w, c)), t).reshape(b, h, w, c)


class TorchMultiheadAttention(nn.Module):
    """Softmax multi-head attention with nn.MultiheadAttention's parameters
    (packed in_proj_weight / in_proj_bias, out_proj), batch first."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        wq, wk, wv = self.in_proj_weight.to(q.dtype).chunk(3)
        bq, bk, bv = self.in_proj_bias.to(q.dtype).chunk(3)
        heads = self.num_heads
        q = _split_heads(F.linear(q, wq, bq), heads)
        k = _split_heads(F.linear(k, wk, bk), heads)
        v = _split_heads(F.linear(v, wv, bv), heads)
        attn = torch.softmax(q @ k.transpose(-1, -2) / q.shape[-1] ** 0.5, dim=-1)
        out = (attn @ v).transpose(1, 2)
        return self.out_proj(out.reshape(out.shape[0], out.shape[1], -1))


class CrossAttentionFusion(nn.Module):
    """Image <- text cross attention over the map's tokens; the residual is
    added to the normalised image tokens, as in the reference."""

    def __init__(self, img_dim: int, text_dim: int = 768, num_heads: int = 4):
        super().__init__()
        self.norm_img = nn.LayerNorm(img_dim, eps=1e-5)
        self.norm_txt = nn.LayerNorm(text_dim, eps=1e-5)
        self.q_proj = nn.Linear(img_dim, img_dim)
        self.k_proj = nn.Linear(text_dim, img_dim)
        self.v_proj = nn.Linear(text_dim, img_dim)
        self.attn = TorchMultiheadAttention(img_dim, num_heads)
        self.out_proj = nn.Linear(img_dim, img_dim)

    def forward(self, x: torch.Tensor, text_tokens: torch.Tensor | None) -> torch.Tensor:
        if text_tokens is None:
            return x
        b, h, w, c = x.shape
        xi = self.norm_img(x.reshape(b, h * w, c))
        t = self.norm_txt(text_tokens)
        out = self.attn(self.q_proj(xi), self.k_proj(t), self.v_proj(t))
        return (xi + self.out_proj(out)).reshape(b, h, w, c)


class DualCrossAttentionFusion(nn.Module):
    """Image <- text, then text <- the updated image: (fused map, updated
    text), the text threaded on to the next fusion site."""

    def __init__(self, img_dim: int, text_dim: int = 768, num_heads: int = 4):
        super().__init__()
        self.norm_img1 = nn.LayerNorm(img_dim, eps=1e-5)
        self.norm_txt1 = nn.LayerNorm(text_dim, eps=1e-5)
        self.q_img = nn.Linear(img_dim, img_dim)
        self.k_txt = nn.Linear(text_dim, img_dim)
        self.v_txt = nn.Linear(text_dim, img_dim)
        self.attn_img_to_txt = TorchMultiheadAttention(img_dim, num_heads)
        self.out_img = nn.Linear(img_dim, img_dim)
        self.norm_txt2 = nn.LayerNorm(text_dim, eps=1e-5)
        self.norm_img2 = nn.LayerNorm(img_dim, eps=1e-5)
        self.q_txt = nn.Linear(text_dim, text_dim)
        self.k_img = nn.Linear(img_dim, text_dim)
        self.v_img = nn.Linear(img_dim, text_dim)
        self.attn_txt_to_img = TorchMultiheadAttention(text_dim, num_heads)
        self.out_txt = nn.Linear(text_dim, text_dim)

    def forward(self, x: torch.Tensor, text_tokens: torch.Tensor | None):
        if text_tokens is None:
            return x, text_tokens
        b, h, w, c = x.shape
        img = x.reshape(b, h * w, c)
        xi, t1 = self.norm_img1(img), self.norm_txt1(text_tokens)
        img_out = self.attn_img_to_txt(self.q_img(xi), self.k_txt(t1), self.v_txt(t1))
        img = img + self.out_img(img_out)
        t2, xi2 = self.norm_txt2(text_tokens), self.norm_img2(img)
        txt_out = self.attn_txt_to_img(self.q_txt(t2), self.k_img(xi2), self.v_img(xi2))
        return img.reshape(b, h, w, c), text_tokens + self.out_txt(txt_out)


class SkipFiLM(nn.Module):
    """x * (1 + gamma(t)) + beta(t), t the text (B, text_dim) or the mean of
    its tokens (B, T, text_dim)."""

    def __init__(self, channels: int, text_dim: int = 768):
        super().__init__()
        self.gamma = nn.Linear(text_dim, channels)
        self.beta = nn.Linear(text_dim, channels)

    def forward(self, x: torch.Tensor, text: torch.Tensor | None) -> torch.Tensor:
        if text is None:
            return x
        if text.dim() == 3:
            text = text.mean(dim=1)
        return x * (1 + self.gamma(text)[:, None, None, :]) + self.beta(text)[:, None, None, :]


class TGDC(nn.Module):
    """Text-guided dynamic conv over tokens (B, N, C)."""

    def __init__(self, dim: int, num_filters: int = 4, kernel_size: int = 3):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))
        self.mlp = nn.Sequential(nn.Linear(dim, dim), nn.ReLU(), nn.Linear(dim, num_filters))
        self.convs = nn.ModuleList(nn.Conv1d(dim, dim, kernel_size, groups=dim)
                                   for _ in range(num_filters))
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, v_tokens: torch.Tensor, t_tokens: torch.Tensor) -> torch.Tensor:
        wgt = torch.softmax(self.mlp(t_tokens.mean(dim=1)), dim=-1)

        def fusion(x):
            xc = x.transpose(1, 2)
            out = 0
            for i, conv in enumerate(self.convs):
                out = out + wgt[:, i, None, None] * depthwise_conv1d(xc, conv.weight, conv.bias)
            return out.transpose(1, 2)

        gamma = self.gamma.to(v_tokens.dtype)
        f1 = gamma * self.norm(fusion(v_tokens))
        return gamma * self.norm(fusion(f1)) + v_tokens


class TGDCFusion(nn.Module):
    def __init__(self, img_dim: int, text_dim: int = 768, num_filters: int = 4):
        super().__init__()
        self.text_proj = nn.Linear(text_dim, img_dim)
        self.tgdc = TGDC(img_dim, num_filters)

    def forward(self, x: torch.Tensor, text_tokens: torch.Tensor | None) -> torch.Tensor:
        if text_tokens is None:
            return x
        b, h, w, c = x.shape
        fused = self.tgdc(x.reshape(b, h * w, c), self.text_proj(text_tokens))
        return fused.reshape(b, h, w, c)
