"""The port's detector (``models/vision.py``), OCR (``models/ocr.py``),
SAM-style segmentation (``models/segmentation.py``) and video DiT
(``models/video.py``) against the JAX package, on the CPU.

Same weights (the JAX init perturbed by a seeded N(0, 0.02), so zero-init
leaves and unit norms carry a signal), same numpy inputs; the losses'
randomness (the video flow loss's t, eps, pin and drop; the sampler's
noise) is drawn from the JAX key as the JAX function splits it and handed
to the port. Tolerance, f32: forwards and losses within 1e-5 of the largest
value (the same products in another order; the CTC loss is
``F.ctc_loss`` against ``optax.ctc_loss``), gradients within 1e-4 of each
leaf's largest. Host-side pieces (CTC greedy collapse, ``nms_host``) are
compared exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from modal_examples_tpu.models import ocr as jocr
from modal_examples_tpu.models import segmentation as jseg
from modal_examples_tpu.models import video as jvideo
from modal_examples_tpu.models import vision as jvision
from modal_examples_tpu_torch.models import ocr as tocr
from modal_examples_tpu_torch.models import segmentation as tseg
from modal_examples_tpu_torch.models import video as tvideo
from modal_examples_tpu_torch.models import vision as tvision
from modal_examples_tpu_torch.utils import tree
from test_torch_time_limit import share_cores

share_cores()

TOL = 1e-5
GRAD_TOL = 1e-4


def _perturbed(tree_, seed: int):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (np.asarray(a, np.float32) + rng.normal(0, 0.02, a.shape)).astype(np.float32),
                        tree_)


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-6))


def _j(tree_):
    return jax.tree.map(jnp.asarray, tree_)


def _flat(node, prefix=""):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _flat(v, f"{prefix}/{k}")
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, node


def _grads_close(loss_fn, params, jloss_fn, np_params):
    """Loss and gradients of the port's ``loss_fn(params)`` against JAX's."""
    want_loss, want = jax.value_and_grad(jloss_fn)(_j(np_params))
    leaves = [p.detach().clone().requires_grad_(True) for p in tree.leaves(params)]
    loss = loss_fn(tree.unflatten(params, leaves))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=TOL)
    got = dict(_flat(tree.unflatten(params, list(torch.autograd.grad(loss, leaves, allow_unused=True)))))
    want = dict(_flat(jax.tree.map(np.asarray, want)))
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        w = want[path]
        g = np.zeros_like(w) if g is None else g.numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_TOL * max(np.abs(w).max(), 1e-6), err_msg=path)


# -- the detector -----------------------------------------------------------------


def _detector(seed=0):
    jcfg = jvision.DetectorConfig()
    np_params = _perturbed(jvision.init_params(jax.random.PRNGKey(seed), jcfg), seed + 11)
    tcfg = tvision.DetectorConfig(**dataclasses.asdict(jcfg))
    return jcfg, tcfg, np_params, tvision.params_from_jax(np_params, tcfg, device="cpu")


def _detector_batch(jcfg, seed=1, B=3):
    return jax.tree.map(np.array, jvision.synthetic_batch(jax.random.PRNGKey(seed), B, jcfg))


def test_detector_forward_matches_jax():
    jcfg, tcfg, np_params, params = _detector()
    batch = _detector_batch(jcfg)
    want = jvision.forward(_j(np_params), jnp.asarray(batch["images"]), jcfg)
    got = tvision.forward(params, torch.from_numpy(batch["images"]), tcfg)
    for key in ("obj", "cls", "ltrb"):
        _close(got[key], want[key])


def test_detector_cell_targets_match_jax():
    jcfg, tcfg, _, _ = _detector()
    batch = _detector_batch(jcfg, seed=2, B=4)
    # two boxes in one cell: the later one overwrites, as the reference's scan does
    batch["boxes"][0, 1] = batch["boxes"][0, 0] + 1.0
    batch["box_mask"][0, 1] = True
    got = tvision._cell_targets(*(torch.from_numpy(batch[k]) for k in ("boxes", "labels", "box_mask")), tcfg)
    for i in range(4):
        want = jvision._cell_targets(*(jnp.asarray(batch[k][i]) for k in ("boxes", "labels", "box_mask")), jcfg)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))


def test_detection_loss_and_grads_match_jax():
    jcfg, tcfg, np_params, params = _detector(seed=3)
    batch = _detector_batch(jcfg, seed=4)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    _grads_close(lambda p: tvision.detection_loss(p, tbatch, tcfg), params,
                 lambda p: jvision.detection_loss(p, _j(batch), jcfg), np_params)


def test_decode_boxes_and_nms_match_jax():
    jcfg, tcfg, np_params, params = _detector(seed=5)
    batch = _detector_batch(jcfg, seed=6, B=2)
    jb = jvision.decode_boxes(jvision.forward(_j(np_params), jnp.asarray(batch["images"]), jcfg), jcfg)
    tb = tvision.decode_boxes(tvision.forward(params, torch.from_numpy(batch["images"]), tcfg), tcfg)
    _close(tb[0], jb[0])
    _close(tb[1], jb[1])
    np.testing.assert_array_equal(tb[2].numpy(), np.asarray(jb[2]))
    for row in range(2):
        for score, iou in ((0.5, 0.5), (0.3, 0.2), (0.0, 0.7)):
            args = (np.asarray(jb[0][row]), np.asarray(jb[1][row]), np.asarray(jb[2][row]))
            want = jvision.nms_host(*args, score_thresh=score, iou_thresh=iou)
            got = tvision.nms_host(tb[0][row], tb[1][row], tb[2][row], score_thresh=score, iou_thresh=iou)
            assert [int(i) for i in got] == [int(i) for i in want]


def test_nms_host_suppresses_overlaps_within_a_class_only():
    boxes = np.array([[0, 0, 10, 10], [1, 1, 11, 11], [0, 0, 10, 10], [50, 50, 60, 60]], np.float32)
    scores = np.array([0.9, 0.8, 0.7, 0.6], np.float32)
    classes = np.array([0, 0, 1, 0])
    got = tvision.nms_host(boxes, scores, classes)
    assert got == jvision.nms_host(boxes, scores, classes) == [0, 2, 3]


def test_detector_synthetic_batch_has_the_reference_shape():
    cfg = tvision.DetectorConfig()
    b = tvision.synthetic_batch(torch.Generator().manual_seed(0), 3, cfg)
    assert tuple(b["images"].shape) == (3, 64, 64, 3) and tuple(b["boxes"].shape) == (3, cfg.max_boxes, 4)
    assert b["box_mask"].sum().item() == 6 and not b["box_mask"][:, 2:].any()
    assert float(b["images"].min()) >= 0.0 and float(b["images"].max()) <= 1.0
    assert torch.isfinite(tvision.detection_loss(tvision.init_params(cfg, device="cpu"), b, cfg))


# -- OCR ---------------------------------------------------------------------------


def _ocr(seed=0):
    jcfg = dataclasses.replace(jocr.OCRConfig(), width=128)
    np_params = _perturbed(jocr.init_params(jax.random.PRNGKey(seed), jcfg), seed + 13)
    tcfg = tocr.OCRConfig(**dataclasses.asdict(jcfg))
    return jcfg, tcfg, np_params, tocr.params_from_jax(np_params, tcfg, device="cpu")


def _lines(seed, B, cfg):
    rng = np.random.default_rng(seed)
    images = rng.random((B, cfg.height, cfg.width, 1)).astype(np.float32)
    labels = np.zeros((B, 10), np.int32)
    for i in range(B):
        n = int(rng.integers(2, 9))
        labels[i, :n] = rng.integers(1, len(jocr.CHARSET) + 1, n)
    return images, labels


def test_ocr_forward_and_ctc_loss_match_jax():
    jcfg, tcfg, np_params, params = _ocr()
    images, labels = _lines(1, 3, jcfg)
    _close(tocr.forward(params, torch.from_numpy(images), tcfg), jocr.forward(_j(np_params), jnp.asarray(images), jcfg))
    _grads_close(lambda p: tocr.ctc_loss(p, torch.from_numpy(images), torch.from_numpy(labels), tcfg), params,
                 lambda p: jocr.ctc_loss(p, jnp.asarray(images), jnp.asarray(labels), jcfg), np_params)


def test_ocr_greedy_decode_collapses_as_jax():
    jcfg, tcfg, np_params, params = _ocr(seed=2)
    images, _ = _lines(3, 4, jcfg)
    assert tocr.greedy_decode(params, torch.from_numpy(images), tcfg) == jocr.greedy_decode(
        _j(np_params), jnp.asarray(images), jcfg)


def test_ocr_greedy_collapse_drops_repeats_and_blanks():
    """Logits whose argmax path is A A _ A B B _ _ C decode to "AABC"."""
    cfg = tocr.OCRConfig(width=36)  # 9 frames
    path = [2, 2, 0, 2, 3, 3, 0, 0, 4]  # label i is CHARSET[i - 1]: 2 is "A"
    head = torch.zeros(cfg.dim, cfg.n_classes)
    head_b = torch.full((cfg.n_classes,), -1.0)
    params = tocr.init_params(cfg, device="cpu")
    params["head"], params["head_b"] = head, head_b
    orig = tocr.forward
    logits = torch.full((1, 9, cfg.n_classes), -5.0)
    logits[0, torch.arange(9), torch.tensor(path)] = 5.0
    try:
        tocr.forward = lambda *a, **k: logits
        assert tocr.greedy_decode(params, torch.zeros(1, cfg.height, cfg.width, 1), cfg) == ["AABC"]
    finally:
        tocr.forward = orig


def test_ocr_codec_matches_jax():
    s = "Invoice #42: $19.99 - paid 3/4"
    assert tocr.encode_text(s) == jocr.encode_text(s) and tocr.CHARSET == jocr.CHARSET
    assert tocr.decode_labels(tocr.encode_text(s)) == jocr.decode_labels(jocr.encode_text(s))


def test_ocr_render_line_and_batch_match_jax():
    cfg = tocr.OCRConfig()
    jcfg = jocr.OCRConfig()
    np.testing.assert_array_equal(tocr.render_line("HELLO 42", cfg), jocr.render_line("HELLO 42", jcfg))
    got = tocr.synthetic_batch(np.random.default_rng(5), 3, cfg)
    want = jocr.synthetic_batch(np.random.default_rng(5), 3, jcfg)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]


# -- segmentation --------------------------------------------------------------------


def _sam(seed=0):
    jcfg = jseg.SAMConfig()
    np_params = _perturbed(jseg.init_params(jax.random.PRNGKey(seed), jcfg), seed + 17)
    tcfg = tseg.SAMConfig(**dataclasses.asdict(jcfg))
    return jcfg, tcfg, np_params, tseg.params_from_jax(np_params, tcfg, device="cpu")


def test_sam_encode_decode_and_loss_match_jax():
    jcfg, tcfg, np_params, params = _sam()
    imgs, pts, masks = (np.array(a) for a in jseg.synthetic_batch(jax.random.PRNGKey(1), 3, jcfg))
    jf = jseg.encode_image(_j(np_params), jnp.asarray(imgs), jcfg)
    tf = tseg.encode_image(params, torch.from_numpy(imgs), tcfg)
    _close(tf, jf)
    jl, ji = jseg.decode_mask(_j(np_params), jf, jnp.asarray(pts), jcfg)
    tl, ti = tseg.decode_mask(params, tf, torch.from_numpy(pts), tcfg)
    _close(tl, jl)
    _close(ti, ji)
    _grads_close(
        lambda p: tseg.segmentation_loss(p, *(torch.from_numpy(a) for a in (imgs, pts, masks)), tcfg), params,
        lambda p: jseg.segmentation_loss(p, *(jnp.asarray(a) for a in (imgs, pts, masks)), jcfg), np_params)


def test_sam_synthetic_scene_clicks_its_own_shape():
    cfg = tseg.SAMConfig()
    gen = torch.Generator().manual_seed(3)
    for _ in range(6):
        img, point, mask = tseg.synthetic_scene(gen, cfg)
        x, y = (point * cfg.image_size).long().tolist()
        assert mask[y, x] == 1.0 and tuple(img.shape) == (64, 64, 3)
    imgs, pts, masks = tseg.synthetic_batch(gen, 2, cfg)
    assert tuple(imgs.shape) == (2, 64, 64, 3) and tuple(pts.shape) == (2, 2) and tuple(masks.shape) == (2, 64, 64)


# -- the video DiT ---------------------------------------------------------------------


def _video(seed=0):
    jcfg = jvideo.VideoDiTConfig.tiny()
    np_params = _perturbed(jvideo.init_params(jax.random.PRNGKey(seed), jcfg), seed + 19)
    tcfg = tvideo.VideoDiTConfig(**dataclasses.asdict(jcfg))
    return jcfg, tcfg, np_params, tvideo.params_from_jax(np_params, tcfg, device="cpu")


def _rng(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_video_patchify_round_trips_as_jax():
    jcfg, tcfg, _, _ = _video()
    x = _rng(1, 2, jcfg.frames, jcfg.img_size, jcfg.img_size, jcfg.channels)
    tp = tvideo.patchify(torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jvideo.patchify(jnp.asarray(x), jcfg)))
    np.testing.assert_array_equal(tvideo.unpatchify(tp, tcfg).numpy(), x)


def test_video_forward_matches_jax():
    jcfg, tcfg, np_params, params = _video()
    B = 2
    x = _rng(2, B, jcfg.frames, jcfg.img_size, jcfg.img_size, jcfg.channels)
    t = np.array([0.3, 0.8], np.float32)
    cond = np.zeros((B, jcfg.frames), np.float32)
    cond[0, 0] = 1.0
    text = _rng(3, B, jcfg.text_len, jcfg.text_dim)
    want = jvideo.forward(_j(np_params), *map(jnp.asarray, (x, t, cond, text)), jcfg)
    got = tvideo.forward(params, *map(torch.from_numpy, (x, t, cond, text)), tcfg)
    _close(got, want)


def test_video_flow_loss_and_grads_match_jax():
    jcfg, tcfg, np_params, params = _video(seed=4)
    B = 3
    video = _rng(5, B, jcfg.frames, jcfg.img_size, jcfg.img_size, jcfg.channels)
    text = _rng(6, B, jcfg.text_len, jcfg.text_dim)
    key = jax.random.PRNGKey(7)
    k1, k2, k3, k4 = jax.random.split(key, 4)  # as the JAX loss splits it
    draws = dict(t=np.array(jax.random.uniform(k1, (B,))), eps=np.array(jax.random.normal(k2, video.shape)),
                 pin=np.array(jax.random.bernoulli(k3, 0.7, (B,))), drop=np.array(jax.random.bernoulli(k4, 0.1, (B,))))
    draws["pin"][:2] = [True, False]  # both kinds of row, whatever the key drew
    draws["drop"][:2] = [False, True]
    # the JAX loss with the same draws: its key replaced by the forced ones
    pin, drop = jnp.asarray(draws["pin"]), jnp.asarray(draws["drop"])

    def jloss(p):
        tb = jnp.asarray(draws["t"])[:, None, None, None, None]
        eps, v = jnp.asarray(draws["eps"]), jnp.asarray(video)
        x_t = (1 - tb) * v + tb * eps
        cond_mask = jnp.zeros((B, jcfg.frames)).at[:, 0].set(pin.astype(jnp.float32))
        x_t = x_t.at[:, 0].set(jnp.where(pin[:, None, None, None], v[:, 0], x_t[:, 0]))
        text_in = jnp.where(drop[:, None, None], jvideo._null_text(p, text.shape), jnp.asarray(text))
        pred = jvideo.forward(p, x_t, jnp.asarray(draws["t"]), cond_mask, text_in, jcfg)
        w = 1.0 - cond_mask[:, :, None, None, None]
        return jnp.sum(w * (pred - (eps - v)) ** 2) / jnp.maximum(jnp.sum(w) * v[0, 0].size, 1.0)

    # the rewrite above is the JAX loss itself with the key's draws: check that once
    unforced = {k: np.asarray(v) for k, v in draws.items()}
    unforced["pin"] = np.asarray(jax.random.bernoulli(k3, 0.7, (B,)))
    unforced["drop"] = np.asarray(jax.random.bernoulli(k4, 0.1, (B,)))
    want_key = jvideo.flow_loss(_j(np_params), key, jnp.asarray(video), jnp.asarray(text), jcfg)
    got_key = tvideo.flow_loss(params, torch.from_numpy(video), torch.from_numpy(text), tcfg,
                               **{k: torch.from_numpy(v) for k, v in unforced.items()})
    np.testing.assert_allclose(got_key.item(), float(want_key), rtol=TOL)
    _grads_close(
        lambda p: tvideo.flow_loss(p, torch.from_numpy(video), torch.from_numpy(text), tcfg,
                                   **{k: torch.from_numpy(v) for k, v in draws.items()}),
        params, jloss, np_params)


@pytest.mark.parametrize("pinned", [False, True], ids=["text-to-video", "image-to-video"])
def test_video_sample_matches_jax(pinned):
    jcfg, tcfg, np_params, params = _video(seed=8)
    B = 2
    text = _rng(9, B, jcfg.text_len, jcfg.text_dim)
    key = jax.random.PRNGKey(10)
    first = _rng(11, B, jcfg.img_size, jcfg.img_size, jcfg.channels) if pinned else None
    want = jvideo.sample(_j(np_params), key, jnp.asarray(text), jcfg, steps=3, guidance=2.5,
                         first_frame=None if first is None else jnp.asarray(first))
    noise = np.array(jax.random.normal(key, (B, jcfg.frames, jcfg.img_size, jcfg.img_size, jcfg.channels)))
    got = tvideo.sample(params, torch.from_numpy(text), tcfg, steps=3, guidance=2.5, noise=torch.from_numpy(noise),
                        first_frame=None if first is None else torch.from_numpy(first))
    _close(got, want)
    if pinned:
        np.testing.assert_array_equal(got[:, 0].numpy(), first)
