"""The rest classes on the tensor-core tile kernels, checked on the CPU: the
group sizes 16 does not divide take the ``ANY_GS`` instances of
``csrc/wna16_mma.cuh`` (K1/K4/K5's forward above 16 rows, K10 at every M) in
bf16 and f16. The kernels run only on the card (``tests/test_torch_cuda_kernels.py``);
here, what they are built on:

* the staging rule ``gemm.mma_stage_groups`` against a brute-force count of the
  groups a 64-row forward tile or a 128-row K10 tile touches at every offset,
  and ``gemm.mma_smem_bytes`` against the stage layout it sizes;
* the forward's masked step-and-fold order (16-row steps, one product of the
  exact ``q - z`` per group a step touches, rows of other groups 0, the
  group's scale folded in once its last row has gone in) emulated in plain
  torch, against the JAX package's ``matmul_xla`` on the rest-class layers of
  ``tests/test_torch_shape_classes.py``;
* a tiny Llama at 4-bit group size 24 (a partial last group in every
  projection) whose logits and LoRA gradients through the port's plain
  versions match the JAX package's.

Inputs are made with NumPy from a seed and handed to both packages."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from autogptq_tpu import AutoGPTQForCausalLM as JaxAuto
from autogptq_tpu.models import arch as jarch
from autogptq_tpu.ops import quantlinear as jqlin
from autogptq_tpu.utils import peft as jpeft
from autogptq_tpu_torch import AutoGPTQForCausalLM
from autogptq_tpu_torch.models import arch
from autogptq_tpu_torch.ops import gemm
from autogptq_tpu_torch.ops import quantlinear as tqlin
from autogptq_tpu_torch.utils import peft
from autogptq_tpu_torch.utils.convert import params_from_jax
from autogptq_tpu_torch.utils.random_checkpoint import write_random_checkpoint
from test_torch_shape_classes import CASES, _layers, _packed

FW_ROWS, T_ROWS = 64, 128     # K rows of a forward tile and of a K10 block


def _touched(a: int, rows: int, gs: int) -> int:
    """Groups that ``rows`` consecutive K rows from row ``a`` touch."""
    return (a + rows - 1) // gs - a // gs + 1


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_stage_groups_cover_every_tile(bits):
    """For every group size 1..256 and every tile offset, the staged group rows
    ``g_lo .. g_lo + mma_stage_groups - 1`` hold every group a forward tile
    (64 rows) or a K10 block (128 rows) touches; where 16 divides the group
    size the fixed 4 and 8 rows of the other instance hold every group of the
    tiles it runs (whole 16-row steps from a multiple of 64 or 128); and the
    wrapper's shared-memory bytes are the stage layout of that many rows."""
    sb = tqlin.storage_bits(bits)
    p = 32 // sb
    for gs in range(1, 257):
        for rows in (FW_ROWS, T_ROWS):
            ng = gemm.mma_stage_groups(gs, rows)
            assert max(_touched(a, rows, gs) for a in range(gs + rows)) <= ng
            if gs % 16 == 0:    # the fixed instance: tiles start at multiples of `rows`
                fixed = 4 if rows == FW_ROWS else 8
                assert max(_touched(t * rows, rows, gs) for t in range(gs)) <= fixed
        fw_ng = 4 if gs % 16 == 0 else gemm.mma_stage_groups(gs, FW_ROWS)
        t_ng = 8 if gs % 16 == 0 else gemm.mma_stage_groups(gs, T_ROWS)
        x_tile = 128 * 72 * 2

        def stage(words, cols, ng):
            return -(-(x_tile + words * cols * 4 + ng * cols * 3) // 16) * 16

        fw = 4 * stage(FW_ROWS // p, 128, fw_ng)
        assert gemm.mma_smem_bytes(sb, gs) == fw <= gemm.MMA_SMEM_LIMIT
        t = 4 * stage(T_ROWS // p, 64, t_ng) + 4 * x_tile
        if t <= gemm.MMA_SMEM_LIMIT:
            assert gemm.mma_smem_bytes(sb, gs, transpose=True) == t
        else:
            assert gs == 1
            with pytest.raises(NotImplementedError, match="group size 1 stages"):
                gemm.mma_smem_bytes(sb, gs, transpose=True)
    # the 16 | gs instances keep their fixed stages (4-bit: 96256 and 169984 bytes)
    assert gemm.mma_smem_bytes(4, 128) == 96256
    assert gemm.mma_smem_bytes(4, 128, transpose=True) == 169984


def _fold_emulation(x: torch.Tensor, tl) -> torch.Tensor:
    """The ANY_GS forward's arithmetic in plain f32 torch: K (the sorted rows)
    in 16-row steps; for each group a step touches, the product of x with the
    exact ``q - z`` of that group's rows (0 on the step's other rows)
    accumulates in ``part``; once the group's last row has gone in, ``acc +=
    s[g] * part`` and ``part`` starts again; bias last."""
    k = tl.in_features
    gs = k if tl.group_size == -1 else tl.group_size
    q = tqlin.codes(tl).float()
    z = tl.zeros.float()
    s = tl.scales.float()
    xs = x.index_select(1, tl.kperm) if tl.kperm is not None else x
    acc = torch.zeros((x.shape[0], tl.out_features))
    part = torch.zeros_like(acc)
    for k0 in range(0, k, 16):
        kend = min(k0 + 16, k)
        g = k0 // gs
        while g * gs < kend:
            lo, hi = g * gs, min(g * gs + gs, k)
            a, b = max(lo, k0), min(hi, kend)
            part += xs[:, a:b] @ (q[a:b] - z[g])
            if hi <= k0 + 16:
                acc += part * s[g]
                part.zero_()
            g += 1
    return acc + tl.bias.float()


@pytest.mark.parametrize("bits, k, n, gs, desc_act, layout", CASES)
def test_fold_order_matches_jax(bits, k, n, gs, desc_act, layout):
    """The emulated step-and-fold order equals JAX's ``matmul_xla`` within
    1e-5 relative in f32 on every rest-class layer (straddling words, a
    partial last group, desc_act)."""
    t = _packed(bits * 1000 + gs, bits, k, n, gs, desc_act)
    jl, tl = _layers(t, bits, k, n, gs)
    x = np.random.default_rng(gs + k).standard_normal((7, k)).astype(np.float32)
    want = np.asarray(jqlin.matmul_xla(jnp.asarray(x), jl))
    got = _fold_emulation(torch.from_numpy(x), tl).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


TINY_G24 = dict(model_type="llama", vocab_size=256, hidden_size=64, intermediate_size=136,
                num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                max_position_embeddings=128, rms_norm_eps=1e-5, rope_theta=10000.0,
                hidden_act="silu", tie_word_embeddings=False)


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_tiny_llama_g24_logits_and_lora_gradients_match_jax(tmp_path):
    """A 2-layer Llama, hidden 64 and MLP 136, at 4-bit group size 24 (the
    last group of 64 rows holds 16, of 136 rows 16): the port's logits of a
    left-padded batch and every LoRA gradient of the masked loss (its backward
    through K10's plain version) against the JAX package's on the CPU, f32,
    within 1e-4 relative (Frobenius)."""
    ckpt = write_random_checkpoint(str(tmp_path), TINY_G24, bits=4, group_size=24, seed=24)
    ref = JaxAuto.from_quantized(ckpt, dtype=jnp.float32)
    jp = jpeft.inject_lora(ref.params, jpeft.GPTQLoraConfig(r=4))
    trainable, _ = jpeft.split_lora_params(jp)
    leaves, treedef = jax.tree_util.tree_flatten(trainable)
    rng = np.random.default_rng(24)
    trainable = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(rng.standard_normal(np.shape(v)).astype(np.float32) * 0.1) for v in leaves])
    tparams = params_from_jax(jpeft.merge_lora_params(jp, trainable), device="cpu",
                              dtype=torch.float32)
    port = AutoGPTQForCausalLM.from_quantized(ckpt, device="cpu", dtype=torch.float32)
    assert port.params["layers"][0]["mlp"]["down_proj"].group_size == 24
    tokens = rng.integers(0, TINY_G24["vocab_size"], (2, 10)).astype(np.int32)
    mask = np.ones_like(tokens)
    mask[1, :2] = 0
    labels = np.where(mask == 1, tokens, -100)

    def jloss(tr):
        logits, _ = jarch.forward(jpeft.merge_lora_params(jp, tr), jnp.asarray(tokens), ref.cfg,
                                  attn_mask=jnp.asarray(mask), backend="xla", dtype=jnp.float32)
        lp = jax.nn.log_softmax(logits[:, :-1], -1)
        nll = -jnp.take_along_axis(lp, jnp.maximum(labels[:, 1:], 0)[:, :, None], -1)[..., 0]
        m = (labels[:, 1:] != -100).astype(jnp.float32)
        return (nll * m).sum() / m.sum(), logits

    (_, want_logits), want_grads = jax.value_and_grad(jloss, has_aux=True)(trainable)
    logits, _ = arch.forward(tparams, torch.from_numpy(tokens).long(), port.cfg,
                             attn_mask=torch.from_numpy(mask))
    valid = mask[:, :, None].astype(bool)
    assert _rel(np.where(valid, logits.detach().numpy(), 0),
                np.where(valid, np.asarray(want_logits), 0)) <= 1e-4
    lp = torch.log_softmax(logits[:, :-1], -1)
    tl = torch.from_numpy(labels)
    nll = -lp.gather(-1, tl[:, 1:].clamp_min(0)[..., None])[..., 0]
    m = (tl[:, 1:] != -100).float()
    ((nll * m).sum() / m.sum()).backward()
    got = peft.trainable_tensors(peft.split_lora_params(tparams)[0])
    want = jax.tree_util.tree_leaves(want_grads)
    assert len(got) == len(want) == 4 * TINY_G24["num_hidden_layers"]
    for t, w in zip(got, want):
        assert t.grad is not None and _rel(t.grad.numpy(), np.asarray(w)) <= 1e-4

