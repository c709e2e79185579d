"""The port's transcription path (``utils/audio.py``, ``utils/metrics.py``,
``models/whisper.py``, ``serving/streaming_asr.py``) against the JAX
package's, on the CPU.

Same weights (the JAX tree, every leaf perturbed by a seeded N(0, 0.02),
carried across by ``params_from_jax``), same numpy inputs. Tolerances: the
audio frontend and the error rates are copies, held bitwise; the encoder
(two convolutions, then attention layers), the decoder's logits and its
head-mean cross-attention in f32 to 1e-4 max abs; greedy tokens identical
(the tiny f32 model's top-2 margins are wide: the test prints the smallest
one); token times to the frame. Loader: bitwise to the JAX loader followed
by ``params_from_jax``.
"""

import dataclasses

import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

import jax
import jax.numpy as jnp

from modal_examples_tpu.models import whisper as jwhisper
from modal_examples_tpu.serving import streaming_asr as jstream
from modal_examples_tpu.utils import audio as jaudio
from modal_examples_tpu.utils import metrics as jmetrics
from modal_examples_tpu_torch.models import whisper as twhisper
from modal_examples_tpu_torch.serving import streaming_asr as tstream
from modal_examples_tpu_torch.utils import audio as taudio
from modal_examples_tpu_torch.utils import metrics as tmetrics
from test_torch_time_limit import share_cores

share_cores()

BOS, EOS = 0, 1


def _perturbed(tree, seed: int):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (np.asarray(a, np.float32) + rng.normal(0, 0.02, a.shape)).astype(np.float32), tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _close(port, ref, atol):
    np.testing.assert_allclose(port.detach().float().numpy(), np.asarray(ref, np.float32), rtol=0, atol=atol)


@pytest.fixture(scope="module")
def tiny():
    cfg = jwhisper.WhisperConfig.test_tiny()
    np_params = _perturbed(jwhisper.init_params(jax.random.PRNGKey(0), cfg), 10)
    tcfg = twhisper.WhisperConfig(**dataclasses.asdict(cfg))
    return cfg, tcfg, jax.tree.map(jnp.asarray, np_params), twhisper.params_from_jax(np_params, tcfg, device="cpu")


def _mel(B, T, n_mels=80, seed=1):
    return np.random.default_rng(seed).standard_normal((B, T, n_mels)).astype(np.float32)


# -- copies -----------------------------------------------------------------------


def test_audio_frontend_is_the_reference_bitwise():
    np.testing.assert_array_equal(taudio.mel_filterbank(), jaudio.mel_filterbank())
    wave = taudio.synth_tone_audio([220.0, 660.0], seconds=1.3)
    np.testing.assert_array_equal(wave, jaudio.synth_tone_audio([220.0, 660.0], seconds=1.3))
    for pad in (True, False):
        np.testing.assert_array_equal(taudio.log_mel_spectrogram(wave, pad_to_chunk=pad),
                                      jaudio.log_mel_spectrogram(wave, pad_to_chunk=pad))
    assert taudio.N_FRAMES == jaudio.N_FRAMES == 3000


def test_error_rates_are_the_reference():
    refs = ["the cat sat on the mat", "hello world", ""]
    hyps = ["the cat sat on mat", "hello there world", "x"]
    assert tmetrics.word_error_rate(refs, hyps) == jmetrics.word_error_rate(refs, hyps)
    assert tmetrics.character_error_rate(refs, hyps) == jmetrics.character_error_rate(refs, hyps)


# -- model ----------------------------------------------------------------------


def test_sinusoids_match_jax():
    """f32 exp and sin/cos of two libraries: an ulp of an argument up to
    1499 is 1.2e-4, of one below 100 under 1e-5."""
    port = twhisper._sinusoids(1500, 512, "cpu")
    _close(port, jwhisper._sinusoids(1500, 512), 2e-4)
    _close(port[:100], jwhisper._sinusoids(100, 512), 1e-5)


def test_encode_and_decode_with_cross_attention_match_jax(tiny):
    cfg, tcfg, jp, tp = tiny
    mel = _mel(2, 200)
    a_ref = jwhisper.encode(jp, jnp.asarray(mel), cfg)
    a = twhisper.encode(tp, torch.from_numpy(mel), tcfg)
    assert a.shape == (2, 100, cfg.dim)
    _close(a, a_ref, 1e-4)
    toks = np.random.default_rng(2).integers(2, cfg.vocab_size, (2, 9)).astype(np.int32)
    logits_ref, attn_ref = jwhisper.decode(jp, jnp.asarray(toks), a_ref, cfg, return_cross_attn=True)
    logits, attn = twhisper.decode(tp, torch.from_numpy(toks).long(), a, tcfg, return_cross_attn=True)
    assert attn.shape == (cfg.n_text_layers, 2, 9, 100) and logits.dtype == torch.float32
    _close(logits, logits_ref, 1e-4)
    _close(attn, attn_ref, 1e-5)
    _close(twhisper.decode(tp, torch.from_numpy(toks).long(), a, tcfg), logits_ref, 1e-4)
    _close(twhisper.forward(tp, torch.from_numpy(mel), torch.from_numpy(toks).long(), tcfg),
           jwhisper.forward(jp, jnp.asarray(mel), jnp.asarray(toks), cfg), 1e-4)


def _min_margin(jp, mel, toks, cfg):
    """Smallest top-2 logit gap over the positions the greedy loop chose."""
    buf = np.concatenate([np.full((toks.shape[0], 1), BOS, np.int32), np.asarray(toks)], axis=1)
    logits = np.asarray(jwhisper.decode(jp, jnp.asarray(buf), jwhisper.encode(jp, mel, cfg), cfg))[:, :-1]
    top2 = np.sort(logits, axis=-1)[..., -2:]
    live = np.cumsum(buf[:, :-1] == EOS, axis=1) == 0  # positions before a row's first EOS
    return float((top2[..., 1] - top2[..., 0])[live].min())


def test_greedy_transcribe_matches_jax(tiny):
    cfg, tcfg, jp, tp = tiny
    mel = _mel(3, 200, seed=3)
    ref = np.asarray(jwhisper.greedy_transcribe(jp, jnp.asarray(mel), cfg, bos_id=BOS, eos_id=EOS, max_tokens=12))
    got = twhisper.greedy_transcribe(tp, torch.from_numpy(mel), tcfg, bos_id=BOS, eos_id=EOS, max_tokens=12)
    assert got.dtype == torch.int32 and got.shape == (3, 11)
    margin = _min_margin(jp, jnp.asarray(mel), ref, cfg)
    print(f"smallest top-2 margin {margin:.3g}")
    assert margin > 1e-3
    np.testing.assert_array_equal(got.numpy(), ref)


def test_greedy_pins_finished_rows_to_eos_as_jax(tiny):
    """EOS taken as a token the model emits at the third position of row 0:
    that row ends there and stays EOS, as the reference's ``done`` keeps it."""
    cfg, tcfg, jp, tp = tiny
    mel = _mel(3, 200, seed=3)
    first = np.asarray(jwhisper.greedy_transcribe(jp, jnp.asarray(mel), cfg, bos_id=BOS, eos_id=EOS, max_tokens=12))
    eos = int(first[0, 2])
    ref = np.asarray(jwhisper.greedy_transcribe(jp, jnp.asarray(mel), cfg, bos_id=BOS, eos_id=eos, max_tokens=12))
    got = twhisper.greedy_transcribe(tp, torch.from_numpy(mel), tcfg, bos_id=BOS, eos_id=eos, max_tokens=12)
    assert (ref[0, 2:] == eos).all()
    np.testing.assert_array_equal(got.numpy(), ref)


def test_align_tokens_and_words_match_jax(tiny):
    cfg, tcfg, jp, tp = tiny
    mel = _mel(2, 200, seed=5)
    toks = np.random.default_rng(6).integers(2, cfg.vocab_size, (2, 10)).astype(np.int32)
    toks[:, [3, 7]] = 32  # word boundaries
    ref = jwhisper.align_tokens(jp, jnp.asarray(mel), jnp.asarray(toks), cfg, bos_id=BOS)
    got = twhisper.align_tokens(tp, torch.from_numpy(mel), torch.from_numpy(toks), tcfg, bos_id=BOS)
    assert got.shape == (2, 10, 2) and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    assert (np.diff(got[..., 0], axis=1) >= 0).all() and got.max() <= 100 * 0.02 + 1e-6
    with_bos = np.concatenate([np.full((2, 1), BOS, np.int32), toks], axis=1)
    np.testing.assert_array_equal(
        twhisper.align_tokens(tp, torch.from_numpy(mel), torch.from_numpy(with_bos), tcfg),
        jwhisper.align_tokens(jp, jnp.asarray(mel), jnp.asarray(with_bos), cfg))
    decode_fn = lambda ids: "".join(chr(97 + i % 26) for i in ids)  # noqa: E731
    for b in range(2):
        ids = list(toks[b]) + [EOS, 5]
        times = np.concatenate([got[b], np.zeros((2, 2), np.float32)])
        assert twhisper.words_with_times(ids, times, decode_fn, eos_ids=(EOS,)) == \
            jwhisper.words_with_times(ids, times, decode_fn, eos_ids=(EOS,))
    cost = np.random.default_rng(7).random((6, 15))
    np.testing.assert_array_equal(twhisper.dtw_path(cost), jwhisper.dtw_path(cost))


def test_whisper_at_base_widths_matches_jax():
    """whisper-base's widths (512, 8 heads of 64, ffn 2048, vocab 51865, 80
    mels), depth 2 each side, 400 frames."""
    cfg = dataclasses.replace(jwhisper.WhisperConfig.base(), n_audio_layers=2, n_text_layers=2)
    np_params = _perturbed(jwhisper.init_params(jax.random.PRNGKey(1), cfg), 11)
    tcfg = twhisper.WhisperConfig(**dataclasses.asdict(cfg))
    tp = twhisper.params_from_jax(np_params, tcfg, device="cpu")
    jp = jax.tree.map(jnp.asarray, np_params)
    del np_params
    mel = _mel(1, 400, seed=8)
    a_ref = jwhisper.encode(jp, jnp.asarray(mel), cfg)
    a = twhisper.encode(tp, torch.from_numpy(mel), tcfg)
    _close(a, a_ref, 1e-4)
    toks = np.array([[BOS, 50, 7000, 51000, 2]], np.int32)
    logits_ref, attn_ref = jwhisper.decode(jp, jnp.asarray(toks), a_ref, cfg, return_cross_attn=True)
    logits, attn = twhisper.decode(tp, torch.from_numpy(toks).long(), a, tcfg, return_cross_attn=True)
    _close(logits, logits_ref, 1e-4)
    _close(attn, attn_ref, 1e-5)


def _write_hf_whisper(tmp_path, np_params, cfg):
    raw = {
        "model.encoder.conv1.weight": np_params["conv1_w"].transpose(2, 1, 0),
        "model.encoder.conv1.bias": np_params["conv1_b"],
        "model.encoder.conv2.weight": np_params["conv2_w"].transpose(2, 1, 0),
        "model.encoder.conv2.bias": np_params["conv2_b"],
        "model.encoder.layer_norm.weight": np_params["enc_ln_w"],
        "model.encoder.layer_norm.bias": np_params["enc_ln_b"],
        "model.decoder.embed_tokens.weight": np_params["tok_emb"],
        "model.decoder.embed_positions.weight": np_params["pos_emb"],
        "model.decoder.layer_norm.weight": np_params["dec_ln_w"],
        "model.decoder.layer_norm.bias": np_params["dec_ln_b"],
    }
    names = {
        "ln1_w": "self_attn_layer_norm.weight", "ln1_b": "self_attn_layer_norm.bias",
        "wq": "self_attn.q_proj.weight", "bq": "self_attn.q_proj.bias", "wk": "self_attn.k_proj.weight",
        "wv": "self_attn.v_proj.weight", "bv": "self_attn.v_proj.bias",
        "wo": "self_attn.out_proj.weight", "bo": "self_attn.out_proj.bias",
        "ln2_w": "final_layer_norm.weight", "ln2_b": "final_layer_norm.bias",
        "fc_w": "fc1.weight", "fc_b": "fc1.bias", "proj_w": "fc2.weight", "proj_b": "fc2.bias",
        "xln_w": "encoder_attn_layer_norm.weight", "xln_b": "encoder_attn_layer_norm.bias",
        "xwq": "encoder_attn.q_proj.weight", "xbq": "encoder_attn.q_proj.bias",
        "xwk": "encoder_attn.k_proj.weight", "xwv": "encoder_attn.v_proj.weight",
        "xbv": "encoder_attn.v_proj.bias", "xwo": "encoder_attn.out_proj.weight",
        "xbo": "encoder_attn.out_proj.bias",
    }
    for side, key, L in (("encoder", "enc", cfg.n_audio_layers), ("decoder", "dec", cfg.n_text_layers)):
        for ours, theirs in names.items():
            if ours in np_params[key]:
                for i in range(L):
                    a = np_params[key][ours][i]
                    raw[f"model.{side}.layers.{i}.{theirs}"] = a.T if a.ndim == 2 else a
    save_file({k: np.ascontiguousarray(v, np.float32) for k, v in raw.items()}, str(tmp_path / "model.safetensors"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whisper_load_hf_weights_is_bitwise_to_the_jax_loader(tmp_path, dtype):
    cfg = jwhisper.WhisperConfig.test_tiny()
    np_params = _perturbed(jwhisper.init_params(jax.random.PRNGKey(2), cfg), 12)
    _write_hf_whisper(tmp_path, np_params, cfg)
    tcfg = twhisper.WhisperConfig(**dataclasses.asdict(cfg))
    ref = jwhisper.load_hf_weights(tmp_path, cfg, dtype=jnp.dtype(dtype))
    want = twhisper.params_from_jax(jax.tree.map(np.asarray, ref), dataclasses.replace(tcfg, dtype=dtype),
                                    device="cpu")
    got = twhisper.load_hf_weights(tmp_path, tcfg, dtype=getattr(torch, dtype), device="cpu")
    got_f, want_f = dict(_flat(got)), dict(_flat(want))
    assert sorted(got_f) == sorted(want_f)
    for path, t in got_f.items():
        assert t.dtype == want_f[path].dtype and t.shape == want_f[path].shape, path
        assert torch.equal(t.float(), want_f[path].float()), path
    assert got["conv1_w"].shape == (cfg.dim, cfg.n_mels, 3)  # PyTorch's [out, in, k]


# -- streaming ----------------------------------------------------------------------


def test_streaming_transcriber_matches_jax(tiny):
    """Both transcribers take the same 3.2 s of tones in 0.4 s pieces (2 s
    window, 0.5 s hop), then flush: every update's texts equal."""
    cfg, tcfg, jp, tp = tiny
    kw = dict(bos_id=BOS, eos_id=EOS, window_s=2.0, hop_s=0.5, max_tokens=8,
              decode_text=lambda toks: ",".join(map(str, toks)))
    ref = jstream.StreamingTranscriber(jp, cfg, **kw)
    port = tstream.StreamingTranscriber(tp, tcfg, **kw)
    wave = taudio.synth_tone_audio([300.0, 1200.0], seconds=3.2)
    n_updates = 0
    for i in range(0, len(wave), 6400):
        a, b = ref.feed(wave[i:i + 6400]), port.feed(wave[i:i + 6400])
        assert (a is None) == (b is None)
        if a is not None:
            n_updates += 1
            assert dataclasses.asdict(b) == dataclasses.asdict(a)
    assert n_updates >= 4
    assert dataclasses.asdict(port.flush()) == dataclasses.asdict(ref.flush())


def test_whisper_entry_points_want_a_card_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = twhisper.WhisperConfig.test_tiny()
    for call in (lambda: twhisper.init_params(cfg), lambda: twhisper.load_hf_weights(tmp_path, cfg),
                 lambda: twhisper.params_from_jax({}, cfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    params = twhisper.init_params(cfg, seed=0, device="cpu")
    assert params["conv1_w"].shape == (cfg.dim, cfg.n_mels, 3) and params["tok_emb"].device.type == "cpu"
