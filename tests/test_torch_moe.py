"""The port's Mixtral path on the CPU against the JAX package, in f32.

* K9's plain version (``gemm.wna16_routed_matmul_ref``, through
  ``quantlinear.matmul_routed``) against the JAX ``matmul_routed``: its real TPU
  kernel in interpret mode, which dots in bf16 (2e-2 relative, as
  ``tests/test_moe_routed.py`` holds it), and its XLA fallback (1e-5).
* The routed product's input gradient (``quantlinear.RoutedMatmul``: K10 per
  selected expert on the card, its plain version here) against ``jax.grad``
  of the JAX routed XLA path (1e-5), and through ``arch.moe_mlp``'s routed
  route against the JAX ``moe_mlp`` (1e-4).
* ``stack_experts`` refuses desc_act; ``params_from_jax`` of a JAX
  ``StackedQuantLinear`` is bit-equal to the port's own stack.
* ``arch.moe_mlp`` on its three routes (routed, dense stacked, expert list)
  against the JAX ``moe_mlp`` (1e-5), with the calibration ``capture`` equal.
* A tiny random Mixtral GPTQ checkpoint (2 layers, hidden 128, 8 experts,
  top-2, 4 heads / 2 KV heads, g32) loaded by both packages and stacked:
  logits (1e-4), greedy tokens of a left-padded batch of 2 (routed decode,
  dense prefill) and beam-4 tokens (8 pairs per step: routed).
* quantize -> save_quantized -> from_quantized of a tiny HF
  ``MixtralForCausalLM`` in both packages, including experts that no
  calibration token reaches (zero Hessians, solved as dead columns).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import grad as jax_grad
from autogptq_tpu import AutoGPTQForCausalLM as JaxAuto
from autogptq_tpu import BaseQuantizeConfig as JaxConfig
from autogptq_tpu.models import arch as jarch
from autogptq_tpu.models import params as jparams
from autogptq_tpu.ops import quantlinear as jqlin
from autogptq_tpu_torch import AutoGPTQForCausalLM, BaseQuantizeConfig
from autogptq_tpu_torch.models import arch
from autogptq_tpu_torch.models import params as params_lib
from autogptq_tpu_torch.ops import gemm, packing
from autogptq_tpu_torch.ops import quantlinear as qlin
from autogptq_tpu_torch.utils.convert import params_from_jax
from autogptq_tpu_torch.utils.random_checkpoint import random_quant_tensors, \
    write_random_checkpoint

TINY = dict(model_type="mixtral", vocab_size=512, hidden_size=128, intermediate_size=256,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            num_local_experts=8, num_experts_per_tok=2, max_position_embeddings=256,
            rms_norm_eps=1e-5, rope_theta=1e6, hidden_act="silu", tie_word_embeddings=False,
            sliding_window=None)


def _packed(rng, k, n, gs, desc_act=False):
    """The same checkpoint tensors as both packages' PackedQuantLinear."""
    t = random_quant_tensors(rng, k, n, 4, gs, desc_act)
    kw = dict(bias=None, bits=4, group_size=gs, in_features=k, out_features=n)
    port = qlin.PackedQuantLinear(qweight=t["qweight"], qzeros=t["qzeros"], scales=t["scales"],
                                  g_idx=t["g_idx"], **kw)
    jax = jqlin.PackedQuantLinear(qweight=jnp.asarray(t["qweight"]),
                                  qzeros=jnp.asarray(t["qzeros"]), scales=jnp.asarray(t["scales"]),
                                  g_idx=jnp.asarray(t["g_idx"]), **kw)
    return port, jax


def _stacks(seed, e, k, n, gs):
    """(port StackedQuantLinear, JAX StackedQuantLinear) of the same experts."""
    rng = np.random.default_rng(seed)
    pairs = [_packed(rng, k, n, gs) for _ in range(e)]
    port = qlin.stack_experts([qlin.from_packed(p, device="cpu", dtype=torch.float32)
                               for p, _ in pairs])
    jax = jqlin.stack_experts([jqlin.from_packed(j) for _, j in pairs])
    return port, jax


@pytest.mark.parametrize("backend, rtol", [("pallas_interpret", 2e-2), ("xla", 1e-5)])
def test_k9_plain_matches_jax_matmul_routed(backend, rtol):
    """E = 4, K = 1024 (the JAX package picks its kb32 layout, which the
    routed TPU kernel needs), a repeated expert in ``sel``."""
    port, jax = _stacks(0, 4, 1024, 128, 128)
    assert jax.layout == "kb32"
    sel = np.array([2, 0, 2], np.int32)
    x = (np.random.default_rng(1).standard_normal((3, 1024)) * 0.1).astype(np.float32)
    got = qlin.matmul_routed(torch.from_numpy(x), port, torch.from_numpy(sel)).numpy()
    want = np.asarray(jqlin.matmul_routed(jnp.asarray(x), jax, jnp.asarray(sel), backend=backend))
    # interpret mode dots in bf16: 2e-2 of the largest output; XLA is f32 throughout
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


def test_routed_gradient_matches_jax_grad():
    """dx of the routed product, a repeated expert and a bias included,
    against jax.grad of the JAX XLA routed path (f32 on both sides)."""
    port, jax = _stacks(8, 4, 256, 192, 64)
    rng = np.random.default_rng(9)
    bias = rng.standard_normal((4, 192)).astype(np.float32)
    port.bias = torch.from_numpy(bias)
    jax = dataclasses.replace(jax, bias=jnp.asarray(bias))
    sel = np.array([3, 1, 3, 0, 2], np.int32)
    x = (rng.standard_normal((5, 256)) * 0.1).astype(np.float32)
    cot = rng.standard_normal((5, 192)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    y = qlin.matmul_routed(xt, port, torch.from_numpy(sel))
    assert y.grad_fn is not None
    (dx,) = torch.autograd.grad((y * torch.from_numpy(cot)).sum(), xt)
    want = jax_grad(lambda xx: jnp.sum(jqlin.matmul_routed(xx, jax, jnp.asarray(sel),
                                                           backend="xla") * cot))(jnp.asarray(x))
    np.testing.assert_allclose(dx.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    for row, e in enumerate(sel):       # row p is g[p] @ W[sel[p]]^T of its own expert
        w = qlin.logical_weight(port.expert(int(e)))
        torch.testing.assert_close(dx[row], torch.from_numpy(cot[row]) @ w.t(), rtol=1e-5,
                                   atol=1e-5)


def test_moe_mlp_routed_gradient_matches_jax():
    """dx through arch.moe_mlp's routed route (2 tokens x top-2 = 4 pairs of 8
    experts) against jax.grad of the JAX moe_mlp on its XLA backend."""
    port, jax, cfg, jcfg = _moe_block(11)
    x = np.random.default_rng(12).standard_normal((2, 1, 128)).astype(np.float32)
    cot = np.random.default_rng(13).standard_normal((2, 1, 128)).astype(np.float32)
    block = _stacked_block(port)
    xt = torch.from_numpy(x).requires_grad_()
    (dx,) = torch.autograd.grad((arch.moe_mlp(block, xt, cfg) * torch.from_numpy(cot)).sum(), xt)
    jblock = jparams.stack_moe_experts({"layers": [{"mlp": jax}]})["layers"][0]["mlp"]
    want = jax_grad(lambda xx: jnp.sum(jarch.moe_mlp(jblock, xx, jcfg, backend="xla") * cot))(
        jnp.asarray(x))
    np.testing.assert_allclose(dx.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_k9_plain_refuses_bad_expert_ids():
    port, _ = _stacks(2, 4, 256, 64, 32)
    x = torch.zeros((2, 256))
    for bad in (-1, 4):
        with pytest.raises(ValueError, match="expert ids"):
            qlin.matmul_routed(x, port, torch.tensor([1, bad], dtype=torch.int32))
    with pytest.raises(ValueError, match="4-bit"):
        gemm.wna16_routed_matmul(x, torch.tensor([1, 2], dtype=torch.int32), port.qweight,
                                 port.scales, port.zeros, 32, bits=8)


def test_stack_experts_refuses_desc_act():
    rng = np.random.default_rng(3)
    layers = [qlin.from_packed(_packed(rng, 256, 64, 32, desc_act=d)[0], device="cpu")
              for d in (False, True)]
    assert layers[1].kperm is not None
    with pytest.raises(ValueError, match="desc_act"):
        qlin.stack_experts(layers)
    sql = qlin.stack_experts([layers[0], layers[0]])
    assert sql.num_experts == 2 and torch.equal(sql.expert(1).qweight, layers[0].qweight)


@pytest.mark.parametrize("k, n, gs", [(1024, 128, 128), (256, 64, 32)])
def test_params_from_jax_stacked_is_bit_equal(k, n, gs):
    """A JAX StackedQuantLinear (kb32 at K = 1024, another layout at K = 256)
    carried across equals the port's own stack of the same checkpoint."""
    port, jax = _stacks(4, 3, k, n, gs)
    got = params_from_jax({"s": jax}, device="cpu", dtype=torch.float32)["s"]
    assert isinstance(got, qlin.StackedQuantLinear) and got.bias is None
    for field in ("qweight", "scales", "zeros"):
        assert torch.equal(getattr(got, field), getattr(port, field)), field
    assert (got.bits, got.group_size, got.in_features, got.out_features) == (4, gs, k, n)


def _moe_block(seed, e=8, hid=128, inter=256, gs=32):
    """Port and JAX MoE blocks (router and expert list) of the same weights."""
    rng = np.random.default_rng(seed)
    router = (rng.standard_normal((hid, e)) / np.sqrt(hid)).astype(np.float32)
    port = {"router": arch.DenseLinear(kernel=torch.from_numpy(router)), "experts": []}
    jax = {"router": jarch.DenseLinear(kernel=jnp.asarray(router), bias=None), "experts": []}
    for _ in range(e):
        pe, je = {}, {}
        for name, (k, n) in (("gate_proj", (hid, inter)), ("up_proj", (hid, inter)),
                             ("down_proj", (inter, hid))):
            p, j = _packed(rng, k, n, gs)
            pe[name] = qlin.from_packed(p, device="cpu", dtype=torch.float32)
            je[name] = jqlin.from_packed(j)
        port["experts"].append(pe)
        jax["experts"].append(je)
    cfg = dict(vocab_size=512, hidden_size=hid, num_layers=1, num_heads=4, num_kv_heads=2,
               head_dim=hid // 4, intermediate_size=inter, moe_num_experts=e, moe_top_k=2)
    return port, jax, arch.ArchConfig(model_type="mixtral", **cfg), \
        jarch.ArchConfig(model_type="mixtral", **cfg)


def _stacked_block(block):
    return params_lib.stack_moe_experts({"layers": [{"mlp": dict(block)}]})["layers"][0]["mlp"]


@pytest.mark.parametrize("route, shape", [("routed", (1, 1)), ("routed", (4, 1)),
                                          ("dense", (2, 5)), ("list", (2, 5))])
def test_moe_mlp_routes_match_jax(monkeypatch, route, shape):
    """Routed: 2 and 8 pairs of (token, expert) <= 8 experts; dense: 20 pairs;
    the expert list with the calibration capture. The JAX side runs its XLA
    backend (its routed route needs the TPU kernel); all three compute the
    same function, f32 on both sides: 1e-5."""
    port, jax, cfg, jcfg = _moe_block(5)
    x = np.random.default_rng(6).standard_normal(shape + (128,)).astype(np.float32)
    calls = []
    real = qlin.matmul_routed
    monkeypatch.setattr(qlin, "matmul_routed", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    cap, jcap = {}, {}
    block = port if route == "list" else _stacked_block(port)
    got = arch.moe_mlp(block, torch.from_numpy(x), cfg, capture=cap if route == "list" else None)
    assert len(calls) == (3 if route == "routed" else 0)
    jblock = jax if route == "list" else jparams.stack_moe_experts(
        {"layers": [{"mlp": jax}]})["layers"][0]["mlp"]
    want = jarch.moe_mlp(jblock, jnp.asarray(x), jcfg, backend="xla",
                         capture=jcap if route == "list" else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert sorted(cap) == sorted(jcap)
    for key in jcap:
        np.testing.assert_allclose(cap[key].numpy(), np.asarray(jcap[key]), rtol=1e-5, atol=1e-5)
    if route == "list":
        assert len(cap) == 24


def test_stack_moe_experts_consumes_the_list():
    port, _, cfg, _ = _moe_block(7)
    params = {"layers": [{"mlp": port}], "embed_tokens": torch.zeros(1)}
    out = params_lib.stack_moe_experts(params)
    mlp = out["layers"][0]["mlp"]
    assert sorted(mlp) == ["experts_stacked", "router"] and "experts" not in port
    assert out["embed_tokens"] is params["embed_tokens"]
    assert mlp["experts_stacked"]["down_proj"].qweight.shape == (8, 256 // 8, 128)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tiny_mixtral"))
    return write_random_checkpoint(path, TINY, bits=4, group_size=32, seed=3)


@pytest.fixture(scope="module")
def models(ckpt):
    port = AutoGPTQForCausalLM.from_quantized(ckpt, device="cpu", dtype=torch.float32)
    ref = JaxAuto.from_quantized(ckpt, dtype=jnp.float32)
    tokens = np.random.default_rng(1).integers(0, 512, size=(2, 9)).astype(np.int32)
    unstacked = (arch.forward(port.params, torch.from_numpy(tokens), port.cfg)[0],
                 jarch.forward(ref.params, jnp.asarray(tokens), ref.cfg, dtype=jnp.float32)[0])
    port.params = params_lib.stack_moe_experts(port.params)
    ref.params = jparams.stack_moe_experts(ref.params)
    return port, ref, tokens, unstacked


def _prompts():
    rng = np.random.default_rng(5)
    return [rng.integers(1, 512, size=7), rng.integers(1, 512, size=4)]


def test_mixtral_config_and_checkpoint(ckpt, models):
    port, _, _, _ = models
    assert port.cfg.moe_num_experts == 8 and port.cfg.moe_top_k == 2
    assert port.cfg.rope_theta == 1e6 and port.cfg.num_kv_heads == 2
    with open(os.path.join(ckpt, "model.safetensors.index.json")) as f:
        names = json.load(f)["weight_map"]
    assert names["model.layers.1.block_sparse_moe.gate.weight"]
    assert names["model.layers.0.block_sparse_moe.experts.7.w2.qweight"]
    assert not any(".mlp." in n for n in names)
    stacked = port.params["layers"][1]["mlp"]["experts_stacked"]
    assert stacked["gate_proj"].qweight.shape == (8, 128 // 8, 256)
    assert stacked["down_proj"].scales.shape == (8, 256 // 32, 128)


def test_mixtral_logits_match_jax(models):
    port, ref, tokens, (list_logits, jax_list_logits) = models
    np.testing.assert_allclose(list_logits.numpy(), np.asarray(jax_list_logits),
                               rtol=1e-4, atol=1e-4)
    got, _ = arch.forward(port.params, torch.from_numpy(tokens), port.cfg)
    want, _ = jarch.forward(ref.params, jnp.asarray(tokens), ref.cfg, backend="xla",
                            dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    # the JAX stacked tree carried across gives the port's own logits
    carried = params_from_jax(ref.params, device="cpu", dtype=torch.float32)
    torch.testing.assert_close(arch.forward(carried, torch.from_numpy(tokens), port.cfg)[0], got,
                               rtol=1e-6, atol=1e-6)


def test_mixtral_greedy_tokens_identical(models, monkeypatch):
    port, ref, _, _ = models
    calls = []
    real = qlin.matmul_routed
    monkeypatch.setattr(qlin, "matmul_routed", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    got = port.generate(_prompts(), max_new_tokens=10)
    assert len(calls) == 3 * 2 * 9                  # 3 per layer per decode step: 4 pairs
    np.testing.assert_array_equal(got, ref.generate(_prompts(), max_new_tokens=10))


def test_mixtral_beam4_tokens_identical(models):
    port, ref, _, _ = models
    got = port.generate(_prompts()[:1], max_new_tokens=8, num_beams=4)
    np.testing.assert_array_equal(got, ref.generate(_prompts()[:1], max_new_tokens=8,
                                                    num_beams=4))


QVOCAB = 256


@pytest.fixture(scope="module")
def fp_mixtral(tmp_path_factory):
    import transformers

    torch.manual_seed(0)
    cfg = transformers.MixtralConfig(
        vocab_size=QVOCAB, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, num_local_experts=8,
        num_experts_per_tok=2, tie_word_embeddings=False)
    path = str(tmp_path_factory.mktemp("tiny_fp_mixtral"))
    transformers.MixtralForCausalLM(cfg).half().save_pretrained(path, safe_serialization=True)
    return path


def _read(path):
    from safetensors import safe_open

    files = [f for f in os.listdir(path) if f.endswith(".safetensors")]
    assert len(files) == 1
    with safe_open(os.path.join(path, files[0]), framework="np") as f:
        return {k: f.get_tensor(k) for k in f.keys()}


@pytest.mark.parametrize("seqs, seqlen", [(4, 32), (1, 3)])
def test_mixtral_quantize_roundtrip_matches_jax(fp_mixtral, tmp_path, seqs, seqlen):
    """4-bit g32 both packages on the same calibration tokens; 1 x 3 tokens
    (6 routed pairs per layer) leaves experts with no token, whose Hessian is
    zero. Codes agree on at least 99% (the solvers' Cholesky factors round
    differently, as in test_torch_quantize_e2e.py), names, dense tensors and
    g_idx exactly; each package loads the other's checkpoint and decodes the
    same greedy tokens."""
    examples = [{"input_ids": np.random.default_rng(9 + i).integers(0, QVOCAB, size=seqlen)}
                for i in range(seqs)]
    kw = dict(bits=4, group_size=32, desc_act=False, sym=False)
    port = AutoGPTQForCausalLM.from_pretrained(fp_mixtral, BaseQuantizeConfig(**kw),
                                               device="cpu", dtype=torch.float32)
    port.quantize(examples, batch_size=4)
    port.save_quantized(str(tmp_path / "port"))
    ref = JaxAuto.from_pretrained(fp_mixtral, quantize_config=JaxConfig(**kw), dtype=jnp.float32)
    ref.quantize(examples, batch_size=4)
    ref.save_quantized(str(tmp_path / "jax"))
    assert len(port.packed_layers) == len(ref.packed_layers) == 2 * 28
    got, want = _read(str(tmp_path / "port")), _read(str(tmp_path / "jax"))
    assert sorted(got) == sorted(want)
    assert "model.layers.1.block_sparse_moe.experts.5.w3.qweight" in got
    same = total = 0
    for name in want:
        if name.endswith(".qweight"):
            a, b = packing.unpack_qweight(got[name], 4), packing.unpack_qweight(want[name], 4)
            same += int(np.sum(a == b))
            total += a.size
        elif name.endswith(".g_idx") or not name.endswith((".qzeros", ".scales")):
            np.testing.assert_array_equal(got[name], want[name])
    assert same / total >= 0.99, same / total
    prompts = [np.arange(1, 8), np.arange(20, 24)]
    for path in (str(tmp_path / "port"), str(tmp_path / "jax")):
        mine = AutoGPTQForCausalLM.from_quantized(path, device="cpu", dtype=torch.float32)
        theirs = JaxAuto.from_quantized(path, dtype=jnp.float32)
        np.testing.assert_array_equal(mine.generate(prompts, max_new_tokens=6),
                                      theirs.generate(prompts, max_new_tokens=6))
