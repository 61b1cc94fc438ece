"""The port's Llama path end to end on the CPU against the JAX package: a
tiny random GPTQ checkpoint (2 layers, hidden 128, 4 heads, 2 KV heads,
vocab 512, desc_act, group 32) loaded by both packages' from_quantized in
f32, compared on logits and on greedy tokens."""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from autogptq_tpu import AutoGPTQForCausalLM as JaxAuto
from autogptq_tpu.models import arch as jarch
from autogptq_tpu_torch import AutoGPTQForCausalLM
from autogptq_tpu_torch.models import arch
from autogptq_tpu_torch.utils import hf_io
from autogptq_tpu_torch.utils.convert import params_from_jax
from autogptq_tpu_torch.utils.random_checkpoint import write_random_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(model_type="llama", vocab_size=512, hidden_size=128, intermediate_size=256,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=256, rms_norm_eps=1e-5, rope_theta=10000.0,
            hidden_act="silu", tie_word_embeddings=False)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tiny_llama"))
    return write_random_checkpoint(path, TINY, bits=4, group_size=32, desc_act=True, seed=3)


@pytest.fixture(scope="module")
def models(ckpt):
    port = AutoGPTQForCausalLM.from_quantized(ckpt, device="cpu", dtype=torch.float32)
    ref = JaxAuto.from_quantized(ckpt, dtype=jnp.float32)
    return port, ref


def _prompts():
    rng = np.random.default_rng(5)
    return [rng.integers(1, 512, size=7), rng.integers(1, 512, size=4)]


def test_logits_match_jax(models):
    port, ref = models
    tokens = np.random.default_rng(1).integers(0, 512, size=(2, 9)).astype(np.int32)
    got, _ = arch.forward(port.params, torch.from_numpy(tokens), port.cfg)
    want, _ = jarch.forward(ref.params, jnp.asarray(tokens), ref.cfg, dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_left_padded_logits_match_jax(models):
    port, ref = models
    tokens = np.random.default_rng(2).integers(0, 512, size=(2, 9)).astype(np.int32)
    mask = np.ones((2, 9), np.int32)
    mask[1, :4] = 0
    got, _ = arch.forward(port.params, torch.from_numpy(tokens), port.cfg,
                          attn_mask=torch.from_numpy(mask))
    want, _ = jarch.forward(ref.params, jnp.asarray(tokens), ref.cfg,
                            attn_mask=jnp.asarray(mask), dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy()[:, 4:], np.asarray(want)[:, 4:], rtol=1e-4, atol=1e-4)


def test_greedy_tokens_identical(models):
    port, ref = models
    got = port.generate(_prompts(), max_new_tokens=12)
    want = ref.generate(_prompts(), max_new_tokens=12)
    assert got.shape == (2, 7 + 12)
    np.testing.assert_array_equal(got, want)


def test_params_from_jax_gives_same_logits(models):
    port, ref = models
    params = params_from_jax(ref.params, device="cpu", dtype=torch.float32)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, 512, size=(1, 6)))
    got, _ = arch.forward(params, tokens, port.cfg)
    want, _ = arch.forward(port.params, tokens, port.cfg)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_sampling_is_seeded(models):
    port, _ = models
    a = port.generate(_prompts(), max_new_tokens=6, temperature=0.8, seed=4)
    b = port.generate(_prompts(), max_new_tokens=6, temperature=0.8, seed=4)
    np.testing.assert_array_equal(a, b)
    r = port.generate(_prompts()[:1], max_new_tokens=3, temperature=0.8,
                      num_return_sequences=3)
    assert r.shape == (3, 7 + 3)


def test_unported_options_raise(models, ckpt, tmp_path):
    port, ref = models
    with pytest.raises(NotImplementedError, match="beam-sample"):
        port.generate(_prompts(), max_new_tokens=2, num_beams=2, temperature=0.5)
    # the contiguous int8 cache, once refused here: JAX's tokens
    np.testing.assert_array_equal(port.generate(_prompts(), max_new_tokens=2, kv_quant=True),
                                  ref.generate(_prompts(), max_new_tokens=2, kv_quant=True))
    cache = arch.KVCache.create(port.cfg, 1, 4, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="mask_contig"):
        arch.forward(port.params, torch.tensor([[3]]), port.cfg, cache=cache,
                     attn_mask=torch.ones((1, 4), dtype=torch.int32))
    from autogptq_tpu_torch.models.registry import get_family

    with pytest.raises(NotImplementedError, match="rope_scaling"):
        get_family("llama").arch_fn(dict(TINY, rope_scaling={"type": "linear", "factor": 2.0}))
    assert hf_io.find_checkpoint_files(ckpt)[0].endswith(".safetensors")
    # the options of the quantize path that wait in the ROADMAP
    with pytest.raises(RuntimeError, match="already quantized"):
        port.quantize([{"input_ids": [1, 2, 3]}])
    from autogptq_tpu_torch import BaseQuantizeConfig, GPTQModel

    def unquantized(**kw):
        return GPTQModel(port.params, port.cfg, port.spec, BaseQuantizeConfig(bits=4, **kw),
                         port.device, port.dtype, quantized=False)

    with pytest.raises(NotImplementedError, match="checkpoint_dir"):
        unquantized().quantize([{"input_ids": [1, 2, 3]}], checkpoint_dir=str(tmp_path))
    with pytest.raises(NotImplementedError, match="lm_head"):
        unquantized(lm_head=True).quantize([{"input_ids": [1, 2, 3]}])
    with pytest.raises(NotImplementedError, match="packed layers"):
        port.save_quantized(str(tmp_path))
    with pytest.raises(NotImplementedError, match="push_to_hub"):
        port.push_to_hub("someone/some-model")
    for fmt, extra in (("marlin", {}), ("gemm", {"quant_method": "awq"})):
        other = tmp_path / fmt
        other.mkdir()
        (other / "config.json").write_text(json.dumps(TINY))
        (other / "quantize_config.json").write_text(json.dumps(
            dict(bits=4, group_size=32, checkpoint_format=fmt, **extra)))
        with pytest.raises(NotImplementedError, match="AWQ and Marlin"):
            AutoGPTQForCausalLM.from_quantized(str(other), device="cpu")
    # the card takes every group size (12: words straddle groups) and refuses
    # only a K that no checkpoint's words can hold
    from autogptq_tpu_torch.ops.quantlinear import check_card_shape

    check_card_shape(4, 128, 128, 12)
    with pytest.raises(NotImplementedError, match="whole 32-bit words"):
        check_card_shape(4, 132, 128, 12)
    for bits in (2, 3, 4, 8):
        check_card_shape(bits, 4096, 11008, 128)


def test_from_quantized_defaults_to_the_card(ckpt):
    if torch.cuda.is_available():
        model = AutoGPTQForCausalLM.from_quantized(ckpt)
        assert model.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            AutoGPTQForCausalLM.from_quantized(ckpt)


def test_import_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import autogptq_tpu_torch, autogptq_tpu_torch.models.base, "
        "autogptq_tpu_torch.utils.generation, autogptq_tpu_torch.utils.convert, "
        "autogptq_tpu_torch.utils.data, autogptq_tpu_torch.quantization.gptq, "
        "autogptq_tpu_torch.utils.random_checkpoint, autogptq_tpu_torch.ops.gemm, "
        "autogptq_tpu_torch.ops.flash_decode, autogptq_tpu_torch.ops.paged_attn, "
        "autogptq_tpu_torch.ops.build, autogptq_tpu_torch.serving, "
        "autogptq_tpu_torch.serving_paged, autogptq_tpu_torch.utils.speculative\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'autogptq_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True, timeout=120)


def test_sources_import_no_jax():
    pkg = os.path.join(REPO, "autogptq_tpu_torch")
    for root, _, files in os.walk(pkg):
        for name in files:
            if not name.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(root, name)).read())
            for node in ast.walk(tree):
                mods = []
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    mods = [node.module or ""]
                for mod in mods:
                    assert mod.split(".")[0] not in ("jax", "jaxlib", "flax", "autogptq_tpu"), \
                        f"{name} imports {mod}"


def test_chip_smoke_imports_no_jax():
    """The card's smoke run imports the port only (its source-path strings name the JAX
    package's kernels, its imports never do)."""
    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    mods += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert "autogptq_tpu_torch.ops" in mods
    assert not [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "flax", "autogptq_tpu")]


def test_entry_points_default_to_the_card():
    """Every entry point that places tensors defaults to the card and, without
    one, raises rather than run on the CPU unasked."""
    import inspect

    from autogptq_tpu_torch.models.base import GPTQModel
    from autogptq_tpu_torch.ops import quantlinear

    for fn in (GPTQModel.from_pretrained, GPTQModel.from_quantized, quantlinear.from_packed,
               arch.KVCache.create):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__qualname__
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            GPTQModel.from_pretrained(REPO)
