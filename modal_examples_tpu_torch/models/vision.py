"""Vision: a single-stage anchor-free object detector (the YOLO/FCOS family).

Counterpart of ``modal_examples_tpu/models/vision.py`` (``DetectorConfig``,
``init_params``, ``forward``, ``_cell_targets``, ``detection_loss``,
``decode_boxes``, ``nms_host``, ``synthetic_batch``): a strided conv stem
(two stride-2 convolutions, a third when the stride is 8), residual conv
blocks with group norm and silu, and a 1x1 head per grid cell giving an
objectness logit, class logits and an ltrb box (softplus distances from the
cell's center, in cell units). The loss is BCE on objectness over every
cell, and cross entropy plus an IoU loss on the one positive cell of each
box (the cell holding its center).

Layouts are the reference's: NHWC images, HWIO kernels
(``layers.conv_same_nhwc``, XLA's "SAME" padding). The convolutions run on
cuDNN with TF32 off (``layers.exact_f32_convs``), as the reference's f32
convolutions are f32. Targets are padded to ``max_boxes`` with a validity
mask. ``synthetic_batch`` draws from a ``torch.Generator`` where the
reference splits a JAX key: the same kind of data, not the same numbers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import resolve_device
from . import layers


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    image_size: int = 64  # square inputs
    n_classes: int = 3
    width: int = 32  # stem channels
    depth: int = 2  # conv blocks after the stem
    stride: int = 8  # total downsample: grid = image_size // stride
    max_boxes: int = 8  # padded targets per image
    dtype: str = "float32"

    @property
    def grid(self) -> int:
        return self.image_size // self.stride

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def init_params(cfg: DetectorConfig, *, seed: int = 0, device=None) -> dict:
    """Random kernels (HWIO, N(0, 1) x (k*k*cin)**-0.5) drawn on the device
    in the model dtype from ``seed``; group-norm scales one, biases zero."""
    r = layers.SeededInit(seed, resolve_device(device), cfg.torch_dtype)
    w = cfg.width

    def conv(k, cin, cout):
        return r.dense(k, k, cin, cout, scale=(k * k * cin) ** -0.5)

    n_out = 1 + cfg.n_classes + 4
    return {
        "stem1": conv(3, 3, w),
        "stem2": conv(3, w, 2 * w),
        "down": conv(3, 2 * w, 2 * w),
        "blocks": [
            {"conv": conv(3, 2 * w, 2 * w), "gn_scale": r.full(1.0, 2 * w), "gn_bias": r.full(0.0, 2 * w)}
            for _ in range(cfg.depth)
        ],
        "head": conv(1, 2 * w, n_out),
        "head_bias": r.full(0.0, n_out),
    }


def params_from_jax(np_params: dict, cfg: DetectorConfig, device=None) -> dict:
    """The JAX tree (numpy leaves) as this module's tree, layouts unchanged."""
    return layers.from_numpy_tree(np_params, cfg.torch_dtype, resolve_device(device))


def _group_norm(x, scale, bias, groups: int = 8, eps: float = 1e-5):
    """Group norm over NHWC ``x`` (the reference's: statistics in x's dtype)."""
    B, H, W, C = x.shape
    xg = x.reshape(B, H, W, groups, C // groups)
    mean = xg.mean(dim=(1, 2, 4), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 2, 4), keepdim=True)
    return ((xg - mean) * torch.rsqrt(var + eps)).reshape(B, H, W, C) * scale + bias


def forward(params: dict, images, cfg: DetectorConfig) -> dict:
    """images [B, S, S, 3] in [0, 1] -> per-cell predictions: ``obj``
    [B, G, G], ``cls`` [B, G, G, n_classes], ``ltrb`` [B, G, G, 4]
    (positive distances in cell units)."""
    with layers.exact_f32_convs():
        x = images.to(cfg.torch_dtype)
        x = F.silu(layers.conv_same_nhwc(x, params["stem1"], 2))
        x = F.silu(layers.conv_same_nhwc(x, params["stem2"], 2))
        if cfg.stride == 8:
            x = F.silu(layers.conv_same_nhwc(x, params["down"], 2))
        for blk in params["blocks"]:
            h = _group_norm(x, blk["gn_scale"], blk["gn_bias"])
            x = x + F.silu(layers.conv_same_nhwc(h, blk["conv"]))
        out = layers.conv_same_nhwc(x, params["head"]) + params["head_bias"]
    n = cfg.n_classes
    return {"obj": out[..., 0], "cls": out[..., 1 : 1 + n], "ltrb": F.softplus(out[..., 1 + n :])}


# -- target assignment and loss ------------------------------------------------


def _cell_targets(boxes, labels, mask, cfg: DetectorConfig):
    """Rasterize padded targets onto the grid, a batch at once: each box's
    positive cell is the one holding its center, later boxes overwriting
    earlier ones in the same cell. boxes [B, max_boxes, 4] xyxy pixels,
    labels [B, max_boxes], mask [B, max_boxes] -> (obj_t [B, G, G] f32,
    cls_t [B, G, G] int64, ltrb_t [B, G, G, 4] f32, pos [B, G, G] bool)."""
    G, s = cfg.grid, cfg.stride
    B, dev = boxes.shape[0], boxes.device
    obj_t = torch.zeros((B, G, G), device=dev)
    cls_t = torch.zeros((B, G, G), dtype=torch.int64, device=dev)
    ltrb_t = torch.zeros((B, G, G, 4), device=dev)
    rows = torch.arange(B, device=dev)
    boxes = boxes.float()
    for i in range(boxes.shape[1]):
        x1, y1, x2, y2 = boxes[:, i].unbind(-1)
        cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
        gx = (cx / s).to(torch.int64).clamp(0, G - 1)
        gy = (cy / s).to(torch.int64).clamp(0, G - 1)
        ccx, ccy = (gx + 0.5) * s, (gy + 0.5) * s  # the positive cell's center
        tgt = torch.stack([ccx - x1, ccy - y1, x2 - ccx, y2 - ccy], dim=-1) / s
        valid = mask[:, i].bool()
        obj_t[rows, gy, gx] = torch.where(valid, torch.ones_like(cx), obj_t[rows, gy, gx])
        cls_t[rows, gy, gx] = torch.where(valid, labels[:, i].to(torch.int64), cls_t[rows, gy, gx])
        ltrb_t[rows, gy, gx] = torch.where(valid[:, None], tgt, ltrb_t[rows, gy, gx])
    return obj_t, cls_t, ltrb_t, obj_t > 0.5


def _iou_ltrb(a, b, eps: float = 1e-6):
    """IoU of two ltrb distance boxes around one center point."""
    inter_w = torch.minimum(a[..., 0], b[..., 0]) + torch.minimum(a[..., 2], b[..., 2])
    inter_h = torch.minimum(a[..., 1], b[..., 1]) + torch.minimum(a[..., 3], b[..., 3])
    inter = inter_w.clamp(min=0) * inter_h.clamp(min=0)
    area_a = (a[..., 0] + a[..., 2]) * (a[..., 1] + a[..., 3])
    area_b = (b[..., 0] + b[..., 2]) * (b[..., 1] + b[..., 3])
    return inter / (area_a + area_b - inter + eps)


def detection_loss(params: dict, batch: dict, cfg: DetectorConfig):
    """batch: ``images`` [B, S, S, 3], ``boxes`` [B, max_boxes, 4] xyxy
    pixels, ``labels`` [B, max_boxes] integer, ``box_mask`` [B, max_boxes]
    bool -> the scalar loss: objectness BCE + class CE + 2 x (1 - IoU), the
    last two over positive cells."""
    preds = forward(params, batch["images"], cfg)
    obj_t, cls_t, ltrb_t, pos = _cell_targets(batch["boxes"], batch["labels"], batch["box_mask"], cfg)
    obj = preds["obj"].float()
    obj_loss = (obj.clamp(min=0) - obj * obj_t + torch.log1p(torch.exp(-obj.abs()))).mean()
    posf = pos.float()
    n_pos = posf.sum().clamp(min=1.0)
    logp = torch.log_softmax(preds["cls"].float(), dim=-1)
    cls_nll = -torch.gather(logp, -1, cls_t[..., None])[..., 0]
    cls_loss = (cls_nll * posf).sum() / n_pos
    iou = _iou_ltrb(preds["ltrb"].float(), ltrb_t)
    box_loss = ((1.0 - iou) * posf).sum() / n_pos
    return obj_loss + cls_loss + 2.0 * box_loss


# -- inference -------------------------------------------------------------------


def decode_boxes(preds: dict, cfg: DetectorConfig):
    """Per-cell predictions -> (boxes [B, G*G, 4] xyxy pixels, scores
    [B, G*G], classes [B, G*G]); every cell is returned and
    :func:`nms_host` filters by score on the host."""
    G, s = cfg.grid, cfg.stride
    dev = preds["obj"].device
    cy, cx = torch.meshgrid(torch.arange(G, device=dev), torch.arange(G, device=dev), indexing="ij")
    ccx, ccy = (cx + 0.5) * s, (cy + 0.5) * s
    ltrb = preds["ltrb"].float() * s
    boxes = torch.stack([ccx - ltrb[..., 0], ccy - ltrb[..., 1], ccx + ltrb[..., 2], ccy + ltrb[..., 3]], dim=-1)
    scores = torch.sigmoid(preds["obj"].float())
    classes = torch.argmax(preds["cls"], dim=-1)
    B = boxes.shape[0]
    return boxes.reshape(B, G * G, 4), scores.reshape(B, G * G), classes.reshape(B, G * G)


def nms_host(boxes, scores, classes, *, score_thresh: float = 0.5, iou_thresh: float = 0.5) -> list:
    """Greedy per-class NMS on the host (numpy); boxes [N, 4] xyxy. Returns
    the kept indices, best score first."""
    boxes, scores, classes = (np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
                              for a in (boxes, scores, classes))
    keep = []
    order = [i for i in np.argsort(-scores) if scores[i] >= score_thresh]
    while order:
        i = order.pop(0)
        keep.append(i)
        rest = []
        for j in order:
            if classes[j] != classes[i]:
                rest.append(j)
                continue
            xx1, yy1 = max(boxes[i, 0], boxes[j, 0]), max(boxes[i, 1], boxes[j, 1])
            xx2, yy2 = min(boxes[i, 2], boxes[j, 2]), min(boxes[i, 3], boxes[j, 3])
            inter = max(0.0, xx2 - xx1) * max(0.0, yy2 - yy1)
            a = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
            b = (boxes[j, 2] - boxes[j, 0]) * (boxes[j, 3] - boxes[j, 1])
            if inter / (a + b - inter + 1e-6) < iou_thresh:
                rest.append(j)
        order = rest
    return keep


# -- synthetic shapes (the fine-tune's stand-in data) --------------------------


def synthetic_batch(generator: torch.Generator, batch: int, cfg: DetectorConfig) -> dict:
    """Geometric-shapes detection data drawn on the generator's device: each
    image holds min(2, max_boxes) shapes (filled rectangle 0, cross 1,
    stripes 2) of 12-24 px on a noisy background, targets padded to
    ``max_boxes``."""
    S, dev = cfg.image_size, generator.device
    n = min(2, cfg.max_boxes)
    wh = 12.0 + 12.0 * torch.rand((batch, n, 2), generator=generator, device=dev)
    xy = 2.0 + (S - 28.0) * torch.rand((batch, n, 2), generator=generator, device=dev)
    boxes = torch.cat([xy, xy + wh], dim=-1)  # xyxy
    labels = torch.randint(0, cfg.n_classes, (batch, n), generator=generator, device=dev)
    yy, xx = torch.meshgrid(torch.arange(S, device=dev, dtype=torch.float32),
                            torch.arange(S, device=dev, dtype=torch.float32), indexing="ij")
    imgs = torch.zeros((batch, S, S), device=dev)
    for i in range(n):
        x1, y1, x2, y2 = (boxes[:, i, j][:, None, None] for j in range(4))
        inside = (xx >= x1) & (xx < x2) & (yy >= y1) & (yy < y2)
        cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
        cross = inside & (((xx - cx).abs() < 2) | ((yy - cy).abs() < 2))
        stripe = inside & (((xx + yy) % 8) < 4)
        lab = labels[:, i][:, None, None]
        shape = torch.where(lab == 0, inside, torch.where(lab == 1, cross, stripe))
        imgs = torch.maximum(imgs, shape.float())
    noise = 0.1 * torch.rand((batch, S, S), generator=generator, device=dev)
    imgs = (imgs * 0.9 + noise).clamp(0, 1)
    pad = cfg.max_boxes - n
    return {
        "images": imgs[..., None].expand(batch, S, S, 3).contiguous(),
        "boxes": F.pad(boxes, (0, 0, 0, pad)),
        "labels": F.pad(labels, (0, pad)),
        "box_mask": torch.arange(cfg.max_boxes, device=dev).expand(batch, cfg.max_boxes) < n,
    }
