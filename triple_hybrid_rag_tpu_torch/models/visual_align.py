"""Cross-modal visual aligner: pixels -> the text encoder's embedding space.

A port of the JAX package's ``models/visual_align.py``. A small patch-transformer
vision encoder is trained contrastively against a FROZEN text embedder on
(rendered image, source text) pairs, so a document image (a scanned page, a
rendered report, a screenshot) embeds near its text. ``EncoderEmbedder.embed_images``
takes this rung for images with no recognizable text when weights are present.

The encoder is a fixed-shape [B, S, S] -> [B, out_dim] forward: patchify is one
reshape, the blocks are the text encoder's ``Block`` at the default compute dtype
(bf16, the reference's ``EncoderConfig`` default) over an f32 residual stream, the
patch embedding, positions, final LayerNorm and projection in f32. Training is
the text encoder's bidirectional InfoNCE with optax's ``adamw`` over a cosine
decay, written in PyTorch (``models/training.py``).

Weight files are the reference's npz (flax names, f32 arrays, ``__cfg_*``
entries), readable both ways. :data:`DEFAULT_ALIGNER_PATH` points where the
reference packages its weights (none ship); :func:`load_aligner` and
:func:`save_aligner` read the attribute at call time, and the port never writes
inside the JAX package.
"""

from __future__ import annotations

import io
import os
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .encoder import Block, EncoderConfig, _Dense, _LayerNorm, init_params_

__all__ = [
    "VisualAlignerConfig",
    "VisualEncoder",
    "image_bytes_to_grid",
    "render_training_pair",
    "train_visual_aligner",
    "VisualAlignEmbedder",
    "save_aligner",
    "load_aligner",
    "DEFAULT_ALIGNER_PATH",
]

DEFAULT_ALIGNER_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "triple_hybrid_rag_tpu", "models", "data", "visual_aligner.npz",
)


@dataclass(frozen=True)
class VisualAlignerConfig:
    image_size: int = 96
    patch: int = 8
    d_model: int = 256
    n_layers: int = 4
    n_heads: int = 4
    d_ff: int = 1024
    out_dim: int = 1024
    temperature: float = 0.05


class VisualEncoder(nn.Module):
    """Patch transformer: f32[B, S, S] grayscale in [0,1] -> unit f32[B, out_dim]."""

    def __init__(self, cfg: VisualAlignerConfig) -> None:
        super().__init__()
        self.cfg = cfg
        n = cfg.image_size // cfg.patch
        self.patch_embed = _Dense(cfg.patch * cfg.patch, cfg.d_model)
        self.pos_embed = nn.Parameter(torch.empty(n * n, cfg.d_model))
        ecfg = EncoderConfig(
            d_model=cfg.d_model, n_layers=cfg.n_layers, n_heads=cfg.n_heads,
            d_mlp=cfg.d_ff, out_dim=cfg.out_dim, max_tokens=n * n,
        )
        self.blocks = nn.ModuleList(Block(ecfg) for _ in range(cfg.n_layers))
        self.ln_final = _LayerNorm(cfg.d_model)
        self.proj = _Dense(cfg.d_model, cfg.out_dim)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        b = images.shape[0]
        n = c.image_size // c.patch
        # patchify: one reshape/transpose, no convs — [B, n*n, patch*patch]
        x = images.reshape(b, n, c.patch, n, c.patch)
        x = x.permute(0, 1, 3, 2, 4).reshape(b, n * n, c.patch * c.patch)
        # per-patch contrast normalization: brightness must not carry signal
        x = x - x.mean(dim=-1, keepdim=True)
        x = x / torch.clamp(x.std(dim=-1, keepdim=True, correction=0), min=1e-3)
        x = self.patch_embed(x) + self.pos_embed[None]
        mask = torch.ones((b, n * n), dtype=torch.bool, device=images.device)
        for blk in self.blocks:
            x = blk(x, mask)
        x = self.ln_final(x)
        pooled = self.proj(x.mean(dim=1)).float()
        return pooled / torch.clamp(torch.linalg.vector_norm(pooled, dim=-1, keepdim=True), min=1e-6)


def init_visual_encoder(cfg: VisualAlignerConfig, seed: int = 0, device=None) -> VisualEncoder:
    """A fresh :class:`VisualEncoder` (flax's initializers, in distribution) on
    ``device``, drawn on the host from ``torch.Generator(seed)``."""
    model = VisualEncoder(cfg)
    init_params_(model, torch.Generator().manual_seed(seed))
    return model.to(resolve_device(device))


def image_bytes_to_grid(data: bytes, size: int = 96) -> Optional[np.ndarray]:
    """Decode any PIL-readable payload to the aligner's f32[S, S] input grid."""
    try:
        from PIL import Image

        img = Image.open(io.BytesIO(data)).convert("L")
        img = img.resize((size, size), Image.BILINEAR)
        return np.asarray(img, np.float32) / 255.0
    except Exception:
        return None


def render_training_pair(
    text: str, rng: np.random.Generator, size: int = 96
) -> Optional[np.ndarray]:
    """Render ``text`` as a document image with augmentations (font size, page
    width, margin, noise, contrast) and return the input grid."""
    from ..ocr_glyph import render_text_image

    width = int(rng.choice([380, 520, 680, 800]))
    font = int(rng.choice([10, 12, 14, 17]))
    margin = int(rng.integers(6, 28))
    # wrap into lines that fit the width at ~0.55*font px per char
    per_line = max(16, int(width / (0.55 * font)))
    words, lines, cur = text.split(), [], ""
    for w in words:
        if len(cur) + len(w) + 1 > per_line:
            lines.append(cur)
            cur = w
        else:
            cur = (cur + " " + w).strip()
        if len(lines) >= 18:
            break
    if cur and len(lines) < 18:
        lines.append(cur)
    if not lines:
        return None
    png = render_text_image("\n".join(lines), width=width, font_size=font,
                            margin=margin)
    grid = image_bytes_to_grid(png, size=size)
    if grid is None:
        return None
    if rng.random() < 0.5:  # speckle noise (scan artifacts)
        noise = rng.random(grid.shape) < 0.01
        grid = np.where(noise, rng.random(grid.shape).astype(np.float32), grid)
    if rng.random() < 0.5:  # contrast/brightness jitter
        grid = np.clip(
            grid * float(rng.uniform(0.7, 1.1)) + float(rng.uniform(-0.1, 0.1)),
            0.0, 1.0,
        ).astype(np.float32)
    return grid.astype(np.float32)


def aligner_loss(model: VisualEncoder, imgs: torch.Tensor, tv: torch.Tensor) -> torch.Tensor:
    """Bidirectional InfoNCE of image embeddings against their text vectors."""
    iv = model(imgs)
    logits = iv @ tv.T / model.cfg.temperature  # [B, B]
    labels = torch.arange(imgs.shape[0], device=imgs.device)
    return (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels)) * 0.5


def train_visual_aligner(
    texts: Sequence[str],
    text_embedder,
    cfg: Optional[VisualAlignerConfig] = None,
    steps: int = 1200,
    batch: int = 64,
    lr: float = 3e-4,
    seed: int = 0,
    renders_per_text: int = 2,
    log=None,
    device=None,
):
    """Contrastive training on ``device`` (CUDA unless ``device="cpu"``): render
    each text, pull its image embedding toward the FROZEN text embedding, push from
    in-batch negatives (bidirectional InfoNCE). AdamW (weight decay 1e-4) over a
    cosine decay from ``lr``. Returns (state dict of the trained weights, cfg)."""
    from .training import AdamW, cosine_decay_schedule

    dev = resolve_device(device)
    cfg = cfg or VisualAlignerConfig()
    rng = np.random.default_rng(seed)
    texts = [t for t in texts if len(t.split()) >= 6]
    if log:
        log(f"rendering {len(texts)} texts x{renders_per_text} ...")
    grids, tvecs = [], []
    tv = np.asarray(text_embedder.embed_texts(list(texts)), np.float32)
    for i, t in enumerate(texts):
        for _ in range(renders_per_text):
            g = render_training_pair(t, rng, size=cfg.image_size)
            if g is not None:
                grids.append(g)
                tvecs.append(tv[i])
    grids = torch.from_numpy(np.stack(grids)).to(dev)
    tvecs = torch.from_numpy(np.stack(tvecs)).to(dev)
    if log:
        log(f"training pairs: {len(grids)}")

    model = init_visual_encoder(cfg, seed, device=dev)
    params = dict(model.named_parameters())
    names = list(params)
    tx = AdamW(cosine_decay_schedule(lr, steps), weight_decay=1e-4)
    opt_state = tx.init(params)
    n = len(grids)
    for s in range(steps):
        idx = torch.from_numpy(rng.choice(n, size=min(batch, n), replace=False)).to(dev)
        loss = aligner_loss(model, grids[idx], tvecs[idx])
        grads = torch.autograd.grad(loss, [params[k] for k in names])
        tx.update_(params, dict(zip(names, grads)), opt_state)
        if log and (s % 100 == 0 or s == steps - 1):
            log(f"  step {s}: loss {float(loss.detach()):.4f}")
    return {k: v.detach() for k, v in model.state_dict().items()}, cfg


def _state_dict(params) -> Dict[str, torch.Tensor]:
    return params.state_dict() if hasattr(params, "state_dict") else params


def save_aligner(params, cfg: VisualAlignerConfig, path=None) -> None:
    """npz in the reference's format: flax-named f32 arrays and one ``__cfg_*``
    entry per config field. ``params`` is a :class:`VisualEncoder` or its state
    dict; ``path`` defaults to :data:`DEFAULT_ALIGNER_PATH`, which must not lie
    inside the JAX package."""
    from .encoder import encoder_params_to_flax
    from .pretrain import refuse_reference_path

    path = refuse_reference_path(DEFAULT_ALIGNER_PATH if path is None else path)
    flat = encoder_params_to_flax(_state_dict(params), cfg.n_heads)
    meta = {f"__cfg_{k}": np.asarray(v) for k, v in cfg.__dict__.items()}
    np.savez(path, **flat, **meta)


def load_aligner(path=None) -> Optional[Tuple[Dict[str, torch.Tensor], VisualAlignerConfig]]:
    """(state dict, cfg) from a weights file (:data:`DEFAULT_ALIGNER_PATH` when
    ``path`` is None), or None when there is none. A file whose entries do not
    fit its own config raises KeyError or ValueError."""
    from .encoder import encoder_params_from_flax

    path = DEFAULT_ALIGNER_PATH if path is None else path
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        kw = {}
        flat = {}
        for k in z.files:
            if k.startswith("__cfg_"):
                name = k[len("__cfg_"):]
                kw[name] = float(z[k]) if name == "temperature" else int(z[k])
            else:
                flat[k] = z[k]
    try:
        cfg = VisualAlignerConfig(**kw)
    except TypeError as e:
        raise ValueError(f"{path}: {e}") from e
    params = encoder_params_from_flax(flat)
    want = VisualEncoder(cfg).state_dict()
    for name, t in want.items():
        if name not in params:
            raise KeyError(f"aligner weights missing parameter {name}")
        if tuple(params[name].shape) != tuple(t.shape):
            raise ValueError(f"shape mismatch for {name}: {tuple(params[name].shape)} vs {tuple(t.shape)}")
    return params, cfg


class VisualAlignEmbedder:
    """Batched image -> text-space embedding over trained aligner weights, on
    ``device`` (CUDA unless ``device="cpu"``)."""

    def __init__(self, params, cfg: VisualAlignerConfig,
                 out_dim: Optional[int] = None, device=None) -> None:
        self.cfg = cfg
        self.out_dim = out_dim or cfg.out_dim
        self.device = resolve_device(device)
        model = VisualEncoder(cfg)
        model.load_state_dict(_state_dict(params))
        self.model = model.to(self.device).eval()

    @torch.no_grad()
    def embed_grids(self, grids: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.asarray(grids, np.float32)).to(self.device)
        out = self.model(x).cpu().numpy()
        if self.out_dim < out.shape[-1]:  # Matryoshka prefix + renorm
            out = out[:, : self.out_dim]
            out /= np.maximum(np.linalg.norm(out, axis=-1, keepdims=True), 1e-6)
        return out

    def embed_image_bytes(self, data: bytes) -> Optional[np.ndarray]:
        g = image_bytes_to_grid(data, size=self.cfg.image_size)
        if g is None:
            return None
        return self.embed_grids(g[None])[0]
