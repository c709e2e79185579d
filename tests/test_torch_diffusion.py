"""The port's text-to-image path (``models/clip_text.py``, ``models/vae.py``,
``models/diffusion.py``: the DiT and the MMDiT, ``utils/images.py``)
against the JAX package's, on the CPU.

Same weights (the JAX tree, every leaf perturbed by a seeded N(0, 0.02):
the reference zero-initialises every modulation leaf and the final
projection, which makes each block the identity and hides the attention),
same numpy inputs, the samplers given the reference's
``jax.random.normal(key, shape)`` as ``noise=``. Tolerances, f32: 1e-4 max
abs for whole models (the VAE's convolutions and group norms, the
transformers' sums), 1e-5 for the CLIP pooled state's gather of the same
rows. Loaders: bitwise to the JAX loader followed by ``params_from_jax``.
"""

import dataclasses

import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

import jax
import jax.numpy as jnp

from modal_examples_tpu.models import clip_text as jclip
from modal_examples_tpu.models import diffusion as jdiff
from modal_examples_tpu.models import vae as jvae
from modal_examples_tpu.utils import images as jimages
from modal_examples_tpu_torch.models import clip_text as tclip
from modal_examples_tpu_torch.models import diffusion as tdiff
from modal_examples_tpu_torch.models import vae as tvae
from modal_examples_tpu_torch.ops import flash_attention as tflash
from modal_examples_tpu_torch.ops import reference as tref
from modal_examples_tpu_torch.utils import images as timages
from test_torch_time_limit import share_cores

share_cores()


def _perturbed(tree, seed: int):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (np.asarray(a, np.float32) + rng.normal(0, 0.02, a.shape)).astype(np.float32), tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def assert_trees_bitwise(got, want):
    got, want = dict(_flat(got)), dict(_flat(want))
    assert sorted(got) == sorted(want)
    for path, t in got.items():
        assert t.dtype == want[path].dtype and t.shape == want[path].shape, path
        assert torch.equal(t.float(), want[path].float()), path


def _close(port, ref, atol):
    np.testing.assert_allclose(port.detach().float().numpy(), np.asarray(ref, np.float32), rtol=0, atol=atol)


def _rng_np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _port_cfg(cls, jcfg):
    return cls(**dataclasses.asdict(jcfg))


def _put(raw, name, w, bias=None):
    """A [in, out] linear under a torch name ([out, in])."""
    raw[name + ".weight"] = np.asarray(w).T
    if bias is not None:
        raw[name + ".bias"] = np.asarray(bias)


def _save(raw, path):
    save_file({k: np.ascontiguousarray(v, np.float32) for k, v in raw.items()}, str(path))


# -- images -------------------------------------------------------------------------


def test_png_codec_is_the_reference():
    img = (_rng_np(0, 5, 7, 3) * 0.5).clip(-1, 1)
    data = timages.to_png(img)
    assert data == jimages.to_png(img)
    np.testing.assert_array_equal(timages.from_png(data), jimages.from_png(data))


# -- CLIP text ------------------------------------------------------------------------


def _clip(jcfg, seed=0):
    np_params = _perturbed(jclip.init_params(jax.random.PRNGKey(seed), jcfg), seed + 20)
    tcfg = _port_cfg(tclip.CLIPTextConfig, jcfg)
    return tcfg, jax.tree.map(jnp.asarray, np_params), tclip.params_from_jax(np_params, tcfg, device="cpu")


@pytest.mark.parametrize("eos", [True, False], ids=["eos", "no-eos"])
def test_clip_forward_matches_jax(eos):
    jcfg = jclip.CLIPTextConfig.tiny()
    tcfg, jp, tp = _clip(jcfg)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size - 1, (3, 20)).astype(np.int32)
    if eos:
        toks[0, 5] = toks[0, 9] = toks[1, 19] = toks[2, 0] = jcfg.eos_token_id  # first EOS wins
    h_ref, p_ref = jclip.forward(jp, jnp.asarray(toks), jcfg)
    h, p = tclip.forward(tp, torch.from_numpy(toks).long(), tcfg)
    _close(h, h_ref, 1e-4)
    _close(p, p_ref, 1e-4)
    idx = [5, 19, 0] if eos else [19, 19, 19]
    _close(p, h.detach().numpy()[np.arange(3), idx], 0.0)


def test_clip_at_clip_l_widths_matches_jax():
    """CLIP-L's widths (768, 12 heads of 64, vocab 49408, 77 positions), depth 2."""
    jcfg = dataclasses.replace(jclip.CLIPTextConfig.clip_l(), n_layers=2)
    tcfg, jp, tp = _clip(jcfg, seed=1)
    toks = np.random.default_rng(2).integers(0, 49406, (2, 77)).astype(np.int32)
    toks[0, 30] = toks[1, 76] = jcfg.eos_token_id
    h_ref, p_ref = jclip.forward(jp, jnp.asarray(toks), jcfg)
    h, p = tclip.forward(tp, torch.from_numpy(toks).long(), tcfg)
    _close(h, h_ref, 1e-4)
    _close(p, p_ref, 1e-4)


def test_clip_load_hf_weights_is_bitwise_to_the_jax_loader(tmp_path):
    jcfg = jclip.CLIPTextConfig.tiny()
    np_params = _perturbed(jclip.init_params(jax.random.PRNGKey(2), jcfg), 22)
    P, E = "text_model.", "text_model.encoder.layers.{}."
    raw = {P + "embeddings.token_embedding.weight": np_params["token_emb"],
           P + "embeddings.position_embedding.weight": np_params["pos_emb"],
           P + "final_layer_norm.weight": np_params["final_ln_scale"],
           P + "final_layer_norm.bias": np_params["final_ln_bias"]}
    lin = {"wq": ("self_attn.q_proj", "bq"), "wk": ("self_attn.k_proj", "bk"), "wv": ("self_attn.v_proj", "bv"),
           "wo": ("self_attn.out_proj", "bo"), "fc1": ("mlp.fc1", "fc1_b"), "fc2": ("mlp.fc2", "fc2_b")}
    L = np_params["layers"]
    for i in range(jcfg.n_layers):
        for w, (name, b) in lin.items():
            _put(raw, E.format(i) + name, L[w][i], L[b][i])
        for ours, theirs in (("ln1_scale", "layer_norm1.weight"), ("ln1_bias", "layer_norm1.bias"),
                             ("ln2_scale", "layer_norm2.weight"), ("ln2_bias", "layer_norm2.bias")):
            raw[E.format(i) + theirs] = L[ours][i]
    _save(raw, tmp_path / "model.safetensors")
    tcfg = _port_cfg(tclip.CLIPTextConfig, jcfg)
    want = tclip.params_from_jax(jax.tree.map(np.asarray, jclip.load_hf_weights(tmp_path, jcfg)), tcfg, device="cpu")
    assert_trees_bitwise(tclip.load_hf_weights(tmp_path, tcfg, device="cpu"), want)


# -- VAE ------------------------------------------------------------------------------


def _vae(jcfg, seed=0):
    np_params = _perturbed(jvae.init_params(jax.random.PRNGKey(seed), jcfg), seed + 30)
    tcfg = _port_cfg(tvae.VAEConfig, jcfg)
    return tcfg, jax.tree.map(jnp.asarray, np_params), tvae.params_from_jax(np_params, tcfg, device="cpu")


@pytest.mark.parametrize("shape", ["tiny", "sd3-widths"])
def test_vae_encode_and_decode_match_jax(shape):
    """tiny; and the SD3 VAE's widths (base 128, 16 latent channels, 32
    groups, its scale and shift) cut to one down and one up level."""
    if shape == "tiny":
        jcfg, hw = jvae.VAEConfig.tiny(), 16
    else:
        jcfg, hw = dataclasses.replace(jvae.VAEConfig.sd3_shape(), channel_mults=(1, 2)), 16
    tcfg, jp, tp = _vae(jcfg)
    img = np.tanh(_rng_np(3, 2, hw, hw, 3))
    z_ref = jvae.encode(jp, jnp.asarray(img), jcfg)
    z = tvae.encode(tp, torch.from_numpy(img), tcfg)
    assert z.shape == (2, hw // jcfg.downscale, hw // jcfg.downscale, jcfg.latent_channels)
    _close(z, z_ref, 1e-4)
    lat = _rng_np(4, 2, hw // jcfg.downscale, hw // jcfg.downscale, jcfg.latent_channels)
    x_ref = jvae.decode(jp, jnp.asarray(lat), jcfg)
    x = tvae.decode(tp, torch.from_numpy(lat), tcfg)
    assert x.shape == (2, hw, hw, 3) and x.abs().max() <= 1.0
    _close(x, x_ref, 1e-4)


def test_vae_stride_two_padding_is_xlas_same():
    """The stride-2 convolution pads (0, 1): a one-sided pad on the other
    side moves the output."""
    rng = np.random.default_rng(5)
    x, w = rng.standard_normal((1, 8, 8, 4)).astype(np.float32), rng.standard_normal((3, 3, 4, 6)).astype(np.float32)
    ref = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w), (2, 2), "SAME",
                                       dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = tvae._conv(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(w.transpose(3, 2, 0, 1)), None, stride=2)
    _close(got.permute(0, 2, 3, 1), ref, 1e-5)


def test_vae_posterior_sample_comes_from_the_generator():
    tcfg, _, tp = _vae(jvae.VAEConfig.tiny())
    img = torch.from_numpy(np.tanh(_rng_np(6, 1, 16, 16, 3)))
    mean = tvae.encode(tp, img, tcfg)
    a = tvae.encode(tp, img, tcfg, generator=torch.Generator().manual_seed(1))
    b = tvae.encode(tp, img, tcfg, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and (a - mean).abs().max().item() > 1e-3


def _write_hf_vae(tmp_path, np_params, quant: bool):
    raw = {}

    def conv(name, w, b):
        raw[name + ".weight"], raw[name + ".bias"] = np.asarray(w).transpose(3, 2, 0, 1), b

    def resnet(prefix, p):
        raw[prefix + ".norm1.weight"], raw[prefix + ".norm1.bias"] = p["norm1_scale"], p["norm1_bias"]
        raw[prefix + ".norm2.weight"], raw[prefix + ".norm2.bias"] = p["norm2_scale"], p["norm2_bias"]
        conv(prefix + ".conv1", p["conv1"], p["conv1_b"])
        conv(prefix + ".conv2", p["conv2"], p["conv2_b"])
        if "shortcut" in p:
            conv(prefix + ".conv_shortcut", p["shortcut"], p["shortcut_b"])

    for side in ("encoder", "decoder"):
        t = np_params[side]
        conv(f"{side}.conv_in", t["conv_in"], t["conv_in_b"])
        conv(f"{side}.conv_out", t["conv_out"], t["conv_out_b"])
        raw[f"{side}.conv_norm_out.weight"], raw[f"{side}.conv_norm_out.bias"] = t["norm_out_scale"], t["norm_out_bias"]
        resnet(f"{side}.mid_block.resnets.0", t["mid_res1"])
        resnet(f"{side}.mid_block.resnets.1", t["mid_res2"])
        a = t["mid_attn"]
        pre = f"{side}.mid_block.attentions.0"
        raw[pre + ".group_norm.weight"], raw[pre + ".group_norm.bias"] = a["norm_scale"], a["norm_bias"]
        for ours, theirs in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"), ("o", "to_out.0")):
            _put(raw, f"{pre}.{theirs}", a[ours], a[ours + "_b"])
        levels, block, n_res, res = (("down", "down_blocks", 2, "downsample") if side == "encoder"
                                     else ("up", "up_blocks", 3, "upsample"))
        for i, blk in enumerate(t[levels]):
            for j in range(n_res):
                resnet(f"{side}.{block}.{i}.resnets.{j}", blk[f"res{j + 1}"])
            if res in blk:
                conv(f"{side}.{block}.{i}.{res}rs.0.conv", blk[res], blk[res + "_b"])
    if quant:
        c = np_params["encoder"]["conv_out"].shape[-1]  # 2 x latent channels
        rng = np.random.default_rng(9)
        raw["quant_conv.weight"] = rng.standard_normal((c, c, 1, 1)).astype(np.float32)
        raw["quant_conv.bias"] = rng.standard_normal(c).astype(np.float32)
        raw["post_quant_conv.weight"] = rng.standard_normal((c // 2, c // 2, 1, 1)).astype(np.float32)
        raw["post_quant_conv.bias"] = rng.standard_normal(c // 2).astype(np.float32)
    _save(raw, tmp_path / "diffusion_pytorch_model.safetensors")


@pytest.mark.parametrize("quant", [False, True], ids=["sd3-layout", "with-quant-convs"])
def test_vae_load_hf_weights_is_bitwise_to_the_jax_loader(tmp_path, quant):
    jcfg = jvae.VAEConfig.tiny()
    np_params = _perturbed(jvae.init_params(jax.random.PRNGKey(3), jcfg), 33)
    _write_hf_vae(tmp_path, np_params, quant)
    tcfg = _port_cfg(tvae.VAEConfig, jcfg)
    ref = jvae.load_hf_weights(tmp_path, jcfg, dtype=jnp.float32)
    want = tvae.params_from_jax(jax.tree.map(np.asarray, ref), tcfg, device="cpu")
    got = tvae.load_hf_weights(tmp_path, tcfg, device="cpu")
    assert_trees_bitwise(got, want)
    assert ("quant_conv" in got) == quant
    img = torch.from_numpy(np.tanh(_rng_np(7, 1, 8, 8, 3)))
    _close(tvae.decode(got, tvae.encode(got, img, tcfg), tcfg),
           jvae.decode(ref, jvae.encode(ref, jnp.asarray(img.numpy()), jcfg), jcfg), 1e-4)


# -- DiT ------------------------------------------------------------------------------


def _dit(control: bool, seed=0):
    jcfg = dataclasses.replace(jdiff.DiTConfig.tiny(), control=control)
    np_params = _perturbed(jdiff.init_params(jax.random.PRNGKey(seed), jcfg), seed + 40)
    tcfg = _port_cfg(tdiff.DiTConfig, jcfg)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, np_params), tdiff.params_from_jax(np_params, tcfg, device="cpu")


@pytest.mark.parametrize("control", [False, True], ids=["plain", "control"])
def test_dit_forward_and_sample_match_jax(control):
    jcfg, tcfg, jp, tp = _dit(control)
    B, hw = 2, jcfg.img_size
    x, text = _rng_np(1, B, hw, hw, 3), _rng_np(2, B, 10, jcfg.text_dim)
    t = np.array([0.3, 0.9], np.float32)
    ctrl = _rng_np(3, B, hw, hw, 3) if control else None
    kw_j = {"control": jnp.asarray(ctrl)} if control else {}
    kw_t = {"control": torch.from_numpy(ctrl)} if control else {}
    v_ref = jdiff.forward(jp, jnp.asarray(x), jnp.asarray(t), jnp.asarray(text), jcfg, **kw_j)
    v = tdiff.forward(tp, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(text), tcfg, **kw_t)
    _close(v, v_ref, 1e-4)
    key = jax.random.PRNGKey(5)
    noise = np.array(jax.random.normal(key, (B, hw, hw, 3)))
    s_ref = jdiff.sample(jp, key, jnp.asarray(text), jcfg, steps=3, guidance=3.0, **kw_j)
    s = tdiff.sample(tp, torch.from_numpy(text), tcfg, steps=3, guidance=3.0, noise=torch.from_numpy(noise), **kw_t)
    _close(s, s_ref, 1e-4)


def test_dit_control_without_the_leaf_raises():
    _, tcfg, _, tp = _dit(False)
    x = torch.zeros(1, 16, 16, 3)
    with pytest.raises(ValueError, match="control_proj"):
        tdiff.forward(tp, x, torch.zeros(1), torch.zeros(1, 4, 64), tcfg, control=x)


# -- MMDiT ----------------------------------------------------------------------------


def _mmdit(jcfg, seed=0):
    np_params = _perturbed(jdiff.mmdit_init(jax.random.PRNGKey(seed), jcfg), seed + 50)
    tcfg = _port_cfg(tdiff.MMDiTConfig, jcfg)
    return tcfg, np_params, tdiff.params_from_jax(np_params, tcfg, device="cpu")


def _mmdit_inputs(cfg, B=2, S=6, seed=1):
    return (_rng_np(seed, B, cfg.img_size, cfg.img_size, cfg.channels), np.array([0.25, 0.75], np.float32)[:B],
            _rng_np(seed + 1, B, S, cfg.text_dim), _rng_np(seed + 2, B, cfg.pooled_dim))


@pytest.mark.parametrize("pre_only", [False, True], ids=["uniform", "pre-only-last"])
def test_mmdit_forward_and_sample_match_jax(pre_only):
    jcfg = jdiff.MMDiTConfig(context_pre_only_last=pre_only)
    tcfg, np_params, tp = _mmdit(jcfg)
    jp = jax.tree.map(jnp.asarray, np_params)
    x, t, text, pooled = _mmdit_inputs(jcfg)
    v_ref = jdiff.mmdit_forward(jp, *map(jnp.asarray, (x, t, text, pooled)), jcfg)
    v = tdiff.mmdit_forward(tp, *map(torch.from_numpy, (x, t, text, pooled)), tcfg)
    assert v.dtype == torch.float32 and v.shape == x.shape
    _close(v, v_ref, 1e-4)
    key = jax.random.PRNGKey(6)
    noise = np.array(jax.random.normal(key, x.shape))
    null_t, null_p = np.zeros_like(text), np.zeros_like(pooled)
    s_ref = jdiff.mmdit_sample(jp, key, *map(jnp.asarray, (text, pooled, null_t, null_p)), jcfg, steps=3)
    s = tdiff.mmdit_sample(tp, *map(torch.from_numpy, (text, pooled, null_t, null_p)), tcfg, steps=3,
                           noise=torch.from_numpy(noise))
    _close(s, s_ref, 1e-4)


def test_mmdit_at_sd3_widths_matches_jax():
    """SD3-Medium's widths (1536, 24 heads of 64, text 4096, pooled 2048, 16
    latent channels, patch 2) in f32, one uniform block plus the pre-only
    last, an 8x8 latent (16 patches) and 6 text tokens."""
    jcfg = dataclasses.replace(jdiff.MMDiTConfig.sd3_shape(), n_layers=2, img_size=8, dtype="float32")
    tcfg, np_params, tp = _mmdit(jcfg, seed=1)
    jp = jax.tree.map(jnp.asarray, np_params)
    del np_params
    x, t, text, pooled = _mmdit_inputs(jcfg, B=1, seed=7)
    _close(tdiff.mmdit_forward(tp, *map(torch.from_numpy, (x, t, text, pooled)), tcfg),
           jdiff.mmdit_forward(jp, *map(jnp.asarray, (x, t, text, pooled)), jcfg), 1e-4)


_plain_attention = tref.attention


def _attention_dropping_the_last_key(q, k, v, causal):
    return _plain_attention(q, k[:, :, :-1], v[:, :, :-1], causal=causal)


def test_zero_init_hides_the_attention_and_perturbed_leaves_show_it(monkeypatch):
    """The reference's init zeroes every modulation leaf and the final
    projection: velocity exactly zero, and a planted attention fault (the
    last key dropped) changes nothing. With the leaves drawn nonzero the
    same fault moves the MMDiT and the DiT far past the tolerance."""
    jcfg = jdiff.MMDiTConfig(context_pre_only_last=True)
    tcfg = _port_cfg(tdiff.MMDiTConfig, jcfg)
    fresh = tdiff.params_from_jax(jax.tree.map(np.asarray, jdiff.mmdit_init(jax.random.PRNGKey(0), jcfg)), tcfg,
                                  device="cpu")
    _, _, perturbed = _mmdit(jcfg)
    args = tuple(map(torch.from_numpy, _mmdit_inputs(jcfg)))
    jdcfg, tdcfg, _, dit = _dit(False)
    dit_fresh = tdiff.params_from_jax(jax.tree.map(np.asarray, jdiff.init_params(jax.random.PRNGKey(0), jdcfg)),
                                      tdcfg, device="cpu")
    dit_args = (torch.from_numpy(_rng_np(1, 2, 16, 16, 3)), torch.tensor([0.3, 0.9]), torch.from_numpy(_rng_np(2, 2, 10, 64)))
    clean = [tdiff.mmdit_forward(fresh, *args, tcfg), tdiff.mmdit_forward(perturbed, *args, tcfg),
             tdiff.forward(dit_fresh, *dit_args, tdcfg), tdiff.forward(dit, *dit_args, tdcfg)]
    assert clean[0].abs().max().item() == 0.0 and clean[2].abs().max().item() == 0.0
    monkeypatch.setattr(tref, "attention", _attention_dropping_the_last_key)
    faulty = [tdiff.mmdit_forward(fresh, *args, tcfg), tdiff.mmdit_forward(perturbed, *args, tcfg),
              tdiff.forward(dit_fresh, *dit_args, tdcfg), tdiff.forward(dit, *dit_args, tdcfg)]
    moved = [(a - b).abs().max().item() for a, b in zip(clean, faulty)]
    assert moved[0] == 0.0 and moved[2] == 0.0  # the fault is invisible on the reference's init
    assert moved[1] > 1e-2 and moved[3] > 1e-2, moved  # and 100x the tolerance once the gates are open


def test_joint_attention_takes_the_flash_entry_in_bf16_only(monkeypatch):
    """bf16 goes through ``flash_attention`` (causal=False, contiguous
    operands; the kernel on a CUDA tensor), once a block; f32 never."""
    calls = []
    real = tflash.flash_attention

    def counting(q, k, v, causal=True, sm_scale=None):
        calls.append((causal, q.is_contiguous() and k.is_contiguous() and v.is_contiguous(), q.shape))
        return real(q, k, v, causal, sm_scale)

    monkeypatch.setattr(tflash, "flash_attention", counting)
    jcfg = jdiff.MMDiTConfig(context_pre_only_last=True)
    tcfg, np_params, tp = _mmdit(jcfg)
    x, t, text, pooled = map(torch.from_numpy, _mmdit_inputs(jcfg))
    v32 = tdiff.mmdit_forward(tp, x, t, text, pooled, tcfg)
    assert calls == []
    bcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    v16 = tdiff.mmdit_forward(tdiff.params_from_jax(np_params, bcfg, device="cpu"), x, t, text, pooled, bcfg)
    S = text.shape[1] + jcfg.n_patches
    assert calls == [(False, True, (2, jcfg.n_heads, S, jcfg.head_dim))] * jcfg.n_layers
    assert torch.isfinite(v16).all() and (v16 - v32).abs().max().item() < 0.1 * v32.abs().max().item()


def _write_hf_mmdit(tmp_path, p, cfg):
    """The MMDiT tree under diffusers SD3Transformer2DModel names."""
    raw = {}
    D, C, ps = cfg.dim, cfg.channels, cfg.patch
    raw["pos_embed.proj.weight"] = p["patch_proj"].reshape(ps, ps, C, D).transpose(3, 2, 0, 1)
    raw["pos_embed.proj.bias"] = p["patch_bias"]
    raw["pos_embed.pos_embed"] = p["pos_emb"][None]
    for ours, theirs in (("t_mlp1", "time_text_embed.timestep_embedder.linear_1"),
                         ("t_mlp2", "time_text_embed.timestep_embedder.linear_2"),
                         ("pool_mlp1", "time_text_embed.text_embedder.linear_1"),
                         ("pool_mlp2", "time_text_embed.text_embedder.linear_2"),
                         ("ctx_proj", "context_embedder")):
        _put(raw, theirs, p[ours], p[ours + "_b"])
    _put(raw, "norm_out.linear", p["final_mod_w"], p["final_mod_b"])
    _put(raw, "proj_out", p["final_proj"], p["final_proj_b"])
    lin = {"img_mod": "norm1.linear", "ctx_mod": "norm1_context.linear", "img_q": "attn.to_q",
           "img_k": "attn.to_k", "img_v": "attn.to_v", "img_o": "attn.to_out.0", "ctx_q": "attn.add_q_proj",
           "ctx_k": "attn.add_k_proj", "ctx_v": "attn.add_v_proj", "ctx_o": "attn.to_add_out",
           "img_fc1": "ff.net.0.proj", "img_fc2": "ff.net.2", "ctx_fc1": "ff_context.net.0.proj",
           "ctx_fc2": "ff_context.net.2"}
    vecs = {"img_qnorm": "attn.norm_q.weight", "img_knorm": "attn.norm_k.weight",
            "ctx_qnorm": "attn.norm_added_q.weight", "ctx_knorm": "attn.norm_added_k.weight"}

    def names(ours):
        if ours.endswith("_mod"):
            return ours + "_w", ours + "_b"
        if "fc" in ours:
            return ours, ours + "_b"
        side, n = ours.split("_")
        return f"{side}_w{n}", f"{side}_b{n}"

    blocks = [({k: v[i] for k, v in p["blocks"].items()}, i) for i in range(p["blocks"]["img_wq"].shape[0])]
    if "last_block" in p:
        blocks.append((p["last_block"], cfg.n_layers - 1))
    for blk, i in blocks:
        T = f"transformer_blocks.{i}."
        for ours, theirs in lin.items():
            w, b = names(ours)
            if w in blk:
                _put(raw, T + theirs, blk[w], blk[b])
        for ours, theirs in vecs.items():
            raw[T + theirs] = blk[ours]
    _save(raw, tmp_path / "diffusion_pytorch_model.safetensors")


@pytest.mark.parametrize("pre_only", [False, True], ids=["uniform", "pre-only-last"])
def test_mmdit_load_hf_weights_is_bitwise_to_the_jax_loader(tmp_path, pre_only):
    jcfg = jdiff.MMDiTConfig(context_pre_only_last=pre_only)
    tcfg, np_params, _ = _mmdit(jcfg, seed=2)
    _write_hf_mmdit(tmp_path, np_params, jcfg)
    ref = jdiff.load_mmdit_hf_weights(tmp_path, jcfg, dtype=jnp.float32)
    want = tdiff.params_from_jax(jax.tree.map(np.asarray, ref), tcfg, device="cpu")
    assert_trees_bitwise(tdiff.load_mmdit_hf_weights(tmp_path, tcfg, device="cpu"), want)
    if pre_only:  # a real SD3 layout under a uniform config fails loudly, as in the reference
        bad = dataclasses.replace(tcfg, context_pre_only_last=False)
        with pytest.raises((KeyError, ValueError)):
            tdiff.load_mmdit_hf_weights(tmp_path, bad, device="cpu")


def test_text_to_image_entry_points_want_a_card_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    calls = [
        lambda: tclip.init_params(tclip.CLIPTextConfig.tiny()),
        lambda: tclip.load_hf_weights(tmp_path, tclip.CLIPTextConfig.tiny()),
        lambda: tvae.init_params(tvae.VAEConfig.tiny()),
        lambda: tvae.load_hf_weights(tmp_path, tvae.VAEConfig.tiny()),
        lambda: tdiff.init_params(tdiff.DiTConfig.tiny()),
        lambda: tdiff.mmdit_init(tdiff.MMDiTConfig.tiny()),
        lambda: tdiff.load_mmdit_hf_weights(tmp_path, tdiff.MMDiTConfig.tiny()),
        lambda: tdiff.params_from_jax({}, tdiff.MMDiTConfig.tiny()),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    params = tdiff.mmdit_init(tdiff.MMDiTConfig.tiny(), seed=0, device="cpu")
    assert params["blocks"]["img_mod_w"].abs().max().item() == 0.0  # the reference's zero-init
    assert tvae.init_params(tvae.VAEConfig.tiny(), device="cpu")["encoder"]["conv_in"].shape == (32, 3, 3, 3)
