"""quantize -> save_quantized -> from_quantized -> generate, the port against
the JAX package on the CPU in f32: a tiny llama (2 layers, hidden 128,
intermediate 256, 4 heads, 2 KV heads, vocab 256) built locally with
``transformers``, the same calibration examples for both.

The two solvers round their Cholesky factors differently (LAPACK against
XLA), so a weight on a rounding edge may take the neighbouring code and push
its error onto later columns: codes agree on at least 99% of the entries
(measured: 99.9% or more), scales to 1e-3 on at least 99%, while tensor
names, shapes, dtypes, ``g_idx`` and ``quantize_config.json`` are equal. Each
package loads the other's checkpoint, and greedy tokens from one checkpoint
are identical in both.

With desc_act one flipped code is enough to part the two runs: it changes the
next layer's activations, so the diagonal of a later Hessian sorts in another
order, and from there the solves differ (measured: layer 0 agrees on 99.9% of
codes, the last linear of layer 1 on half). Both results are equally good
GPTQ solutions, so the desc_act case holds the codes, ``g_idx`` and
``qzeros`` of layer 0's attention, which no flip precedes, and holds the whole
model to the same distance from the fp model in both packages."""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from autogptq_tpu import AutoGPTQForCausalLM as JaxAuto
from autogptq_tpu import BaseQuantizeConfig as JaxConfig
from autogptq_tpu_torch import AutoGPTQForCausalLM, BaseQuantizeConfig
from autogptq_tpu_torch.ops import packing
from autogptq_tpu_torch.utils.data import random_calibration_examples

VOCAB = 256
CASES = [  # bits, group_size, desc_act, sym
    (4, 32, False, True),
    (4, 32, True, False),
    (2, 32, False, False),
    (3, 32, False, True),
    (8, 64, False, False),
]


@pytest.fixture(scope="module")
def fp_dir(tmp_path_factory):
    import transformers

    torch.manual_seed(0)
    cfg = transformers.LlamaConfig(
        vocab_size=VOCAB, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, tie_word_embeddings=False)
    path = str(tmp_path_factory.mktemp("tiny_fp_llama"))
    # fp16 weights, so that the fp16 tensors save_quantized writes are exact
    transformers.LlamaForCausalLM(cfg).half().save_pretrained(path, safe_serialization=True)
    return path


def _examples():
    examples = random_calibration_examples(VOCAB, n=8, seqlen=48, seed=1)
    examples[3] = {"input_ids": examples[3]["input_ids"][:31]}      # one left-padded row
    return examples


def _read(path):
    from safetensors import safe_open

    files = [f for f in os.listdir(path) if f.endswith(".safetensors")]
    assert len(files) == 1
    with safe_open(os.path.join(path, files[0]), framework="np") as f:
        return files[0], {k: f.get_tensor(k) for k in f.keys()}, f.metadata()


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}bit-g{c[1]}-act{int(c[2])}")
def quantized(request, fp_dir, tmp_path_factory):
    bits, gs, desc_act, sym = request.param
    kw = dict(bits=bits, group_size=gs, desc_act=desc_act, sym=sym)
    out = tmp_path_factory.mktemp(f"q{bits}")
    port = AutoGPTQForCausalLM.from_pretrained(fp_dir, BaseQuantizeConfig(**kw), device="cpu",
                                               dtype=torch.float32)
    port.quantize(_examples(), batch_size=4)
    port.save_quantized(str(out / "port"))
    ref = JaxAuto.from_pretrained(fp_dir, quantize_config=JaxConfig(**kw), dtype=jnp.float32)
    ref.quantize(_examples(), batch_size=4)
    ref.save_quantized(str(out / "jax"))
    return bits, port, ref, str(out / "port"), str(out / "jax")


def test_checkpoints_agree(quantized):
    bits, port, _, port_dir, jax_dir = quantized
    pname, got, pmeta = _read(port_dir)
    jname, want, jmeta = _read(jax_dir)
    gs = port.quantize_config.group_size
    assert pname == jname == f"gptq_model-{bits}bit-{gs}g.safetensors"
    assert pmeta["quantizer"].startswith("autogptq_tpu_torch:")
    for key in ("format", "gptq_bits", "gptq_group_size", "gptq_desc_act", "gptq_damp_percent"):
        assert pmeta[key] == jmeta[key], key
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].shape == want[name].shape and got[name].dtype == want[name].dtype, name
    with open(os.path.join(port_dir, "quantize_config.json")) as f:
        pq = json.load(f)
    with open(os.path.join(jax_dir, "quantize_config.json")) as f:
        assert pq == json.load(f)
    with open(os.path.join(port_dir, "config.json")) as f:
        assert json.load(f)["quantization_config"]["bits"] == bits

    same = total = 0
    held = "model.layers.0.self_attn" if port.quantize_config.desc_act else "model.layers"
    for name in want:
        if name.startswith("model.layers") and not name.startswith(held):
            continue
        if name.endswith(".g_idx"):
            np.testing.assert_array_equal(got[name], want[name])
        elif name.endswith(".qzeros"):
            a, b = packing.unpack_qzeros(got[name], bits), packing.unpack_qzeros(want[name], bits)
            assert np.mean(a == b) >= 0.99, name
        elif name.endswith(".scales"):
            close = np.isclose(got[name].astype(np.float32), want[name].astype(np.float32),
                               rtol=1e-3, atol=0)
            assert np.mean(close) >= 0.99, name
        elif name.endswith(".qweight"):
            a, b = packing.unpack_qweight(got[name], bits), packing.unpack_qweight(want[name], bits)
            same += int(np.sum(a == b))
            total += a.size
        else:                                   # dense tensors pass through unchanged
            np.testing.assert_array_equal(got[name], want[name])
    if not port.quantize_config.desc_act:
        assert total == 2 * (2 * 128 * 128 + 2 * 128 * 64 + 3 * 128 * 256)   # all 14 linears
    assert same / total >= 0.99, same / total


def test_solver_losses_agree(quantized):
    _, port, _, _, _ = quantized
    stats = port.quantize_stats
    assert sorted(stats["phases"]) == ["hessian", "pack", "reforward", "solver"]
    assert len(stats["losses"]) == 14 and all(np.isfinite(v) for v in stats["losses"].values())
    assert port.quantized and len(port.packed_layers) == 14


def test_each_package_loads_the_others_checkpoint(quantized):
    _, port, ref, port_dir, jax_dir = quantized
    prompts = [np.arange(1, 8), np.arange(20, 24)]
    for path in (port_dir, jax_dir):
        mine = AutoGPTQForCausalLM.from_quantized(path, device="cpu", dtype=torch.float32)
        theirs = JaxAuto.from_quantized(path, dtype=jnp.float32)
        got = mine.generate(prompts, max_new_tokens=10)
        np.testing.assert_array_equal(got, theirs.generate(prompts, max_new_tokens=10))
        tokens = np.random.default_rng(2).integers(0, VOCAB, size=(2, 9)).astype(np.int32)
        np.testing.assert_allclose(mine.forward(tokens).numpy(),
                                   np.asarray(theirs.forward(tokens)), rtol=1e-4, atol=1e-4)
    # the reloaded model is the in-memory quantized model, bit for bit
    tokens = np.arange(12)[None]
    reloaded = AutoGPTQForCausalLM.from_quantized(port_dir, device="cpu", dtype=torch.float32)
    assert torch.equal(reloaded.forward(tokens), port.forward(tokens))
    np.testing.assert_array_equal(port.generate(prompts, max_new_tokens=6),
                                  reloaded.generate(prompts, max_new_tokens=6))


def test_quantized_logits_approach_the_fp_model(fp_dir, quantized):
    bits, port, ref, _, _ = quantized
    fp = AutoGPTQForCausalLM.from_pretrained(fp_dir, device="cpu", dtype=torch.float32)
    tokens = np.random.default_rng(3).integers(0, VOCAB, size=(2, 16))
    want = fp.forward(tokens)
    rel = float((port.forward(tokens) - want).norm() / want.norm())
    rel_jax = float((torch.from_numpy(np.asarray(ref.forward(tokens))) - want).norm()
                    / want.norm())
    assert rel < {2: 1.5, 3: 0.6, 4: 0.3, 8: 0.02}[bits], rel
    assert abs(rel - rel_jax) <= 0.2 * rel_jax, (rel, rel_jax)


def test_sharded_save_loads(fp_dir, tmp_path):
    port = AutoGPTQForCausalLM.from_pretrained(
        fp_dir, BaseQuantizeConfig(bits=4, group_size=64, desc_act=False,
                                   true_sequential=False), device="cpu", dtype=torch.float32)
    port.quantize(_examples()[:4], batch_size=2)
    port.save_quantized(str(tmp_path), max_shard_size=100_000)
    names = sorted(os.listdir(tmp_path))
    assert "gptq_model-4bit-64g.safetensors.index.json" in names
    assert sum(n.endswith(".safetensors") for n in names) > 1
    tokens = np.arange(10)[None]
    reloaded = AutoGPTQForCausalLM.from_quantized(str(tmp_path), device="cpu",
                                                  dtype=torch.float32)
    assert torch.equal(reloaded.forward(tokens), port.forward(tokens))
    theirs = JaxAuto.from_quantized(str(tmp_path), dtype=jnp.float32)
    np.testing.assert_allclose(reloaded.forward(tokens).numpy(),
                               np.asarray(theirs.forward(tokens)), rtol=1e-4, atol=1e-4)


def test_quantize_refuses_what_is_not_ported(fp_dir, tmp_path):
    def model(**kw):
        return AutoGPTQForCausalLM.from_pretrained(
            fp_dir, BaseQuantizeConfig(bits=4, group_size=32, **kw), device="cpu",
            dtype=torch.float32)

    with pytest.raises(NotImplementedError, match="checkpoint_dir"):
        model().quantize(_examples(), checkpoint_dir=str(tmp_path))
    with pytest.raises(NotImplementedError, match="lm_head"):
        model(lm_head=True).quantize(_examples())
    with pytest.raises(NotImplementedError, match="push_to_hub"):
        model().push_to_hub("someone/some-model")
    with pytest.raises(RuntimeError, match="only saves quantized"):
        model().save_quantized(str(tmp_path))


def test_data_helpers_match_jax():
    from autogptq_tpu.models.base import _pad_examples as jax_pad
    from autogptq_tpu.utils import data as jdata
    from autogptq_tpu_torch.models.base import _pad_examples
    from autogptq_tpu_torch.utils import data as tdata

    got = tdata.random_calibration_examples(VOCAB, n=5, seqlen=9, seed=4)
    want = jdata.random_calibration_examples(VOCAB, n=5, seqlen=9, seed=4)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
        assert a["input_ids"].dtype == b["input_ids"].dtype
    ragged = [{"input_ids": e["input_ids"][:n]} for e, n in zip(got, (9, 4, 7, 1, 9))]
    for a, b in zip(_pad_examples(ragged), jax_pad(ragged)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(0)
    blocks = [dict(input_ids=rng.integers(0, 9, (r, w)), attention_mask=np.ones((r, w), np.int64),
                   labels=rng.integers(0, 9, (r, w - 1))) for r, w in ((2, 5), (1, 8), (3, 3))]
    a, b = tdata.collate_data(blocks, pad_token_id=7), jdata.collate_data(blocks, pad_token_id=7)
    assert sorted(a) == sorted(b)
    for key in b:
        np.testing.assert_array_equal(a[key], b[key])


def test_random_fp_checkpoint_loads_in_both_packages(tmp_path):
    from autogptq_tpu_torch.utils.random_checkpoint import write_random_fp_checkpoint

    cfg = dict(model_type="llama", vocab_size=VOCAB, hidden_size=64, intermediate_size=128,
               num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2,
               rms_norm_eps=1e-5, rope_theta=10000.0, hidden_act="silu",
               tie_word_embeddings=False)
    path = write_random_fp_checkpoint(str(tmp_path / "fp"), cfg, seed=5)
    port = AutoGPTQForCausalLM.from_pretrained(path, device="cpu", dtype=torch.float32)
    ref = JaxAuto.from_pretrained(path, dtype=jnp.float32)
    tokens = np.random.default_rng(6).integers(0, VOCAB, size=(2, 11)).astype(np.int32)
    mask = np.ones((2, 11), np.int32)
    mask[1, :3] = 0
    got = port.forward(tokens, mask).numpy()
    want = np.asarray(ref.forward(tokens, mask))
    assert np.isfinite(got).all() and 0.1 < np.abs(got).max() < 100       # activations of order one
    np.testing.assert_allclose(got[:, 3:], want[:, 3:], rtol=1e-4, atol=1e-4)
    # a cut to fewer layers has the full checkpoint's first layers
    cut = write_random_fp_checkpoint(str(tmp_path / "cut"), dict(cfg, num_hidden_layers=1), seed=5)
    one = AutoGPTQForCausalLM.from_pretrained(cut, device="cpu", dtype=torch.float32)
    assert torch.equal(one.params["layers"][0]["mlp"]["down_proj"].kernel,
                       port.params["layers"][0]["mlp"]["down_proj"].kernel)
    assert not port.quantized and port.quantize_config.model_name_or_path == path
