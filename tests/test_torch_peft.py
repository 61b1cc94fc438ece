"""LoRA, AdaLoRA and adaption-prompt training on a quantized model in the port
(``autogptq_tpu_torch.utils.peft``): every case of ``tests/test_peft.py`` on
the port, and parity with the JAX package on one tiny random GPTQ checkpoint
(2 layers, hidden 128, desc_act, group 32) loaded by both packages in f32,
with the adapters carried across by ``params_from_jax`` and nonzero B, E and
gate drawn with NumPy: logits, every adapter gradient of the masked causal-LM
loss of ``examples/peft/peft_lora_clm_instruction_tuning.py``, and the saved
adapter file."""

import numpy as np
import pytest
import torch
from safetensors.numpy import load_file

import jax
import jax.numpy as jnp
from autogptq_tpu import AutoGPTQForCausalLM as JaxAuto
from autogptq_tpu.models import arch as jarch
from autogptq_tpu.models.registry import get_family as jget_family
from autogptq_tpu.utils import peft as jpeft
from autogptq_tpu_torch import AutoGPTQForCausalLM
from autogptq_tpu_torch.models import arch
from autogptq_tpu_torch.models.registry import get_family
from autogptq_tpu_torch.ops.quantlinear import QuantLinear
from autogptq_tpu_torch.utils import generation
from autogptq_tpu_torch.utils import peft
from autogptq_tpu_torch.utils.convert import params_from_jax
from autogptq_tpu_torch.utils.random_checkpoint import write_random_checkpoint

TINY = dict(model_type="llama", vocab_size=512, hidden_size=128, intermediate_size=256,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=256, rms_norm_eps=1e-5, rope_theta=10000.0,
            hidden_act="silu", tie_word_embeddings=False)
VOCAB = TINY["vocab_size"]
KINDS = ("lora", "adalora", "adaption")


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tiny_llama_peft"))
    return write_random_checkpoint(path, TINY, bits=4, group_size=32, desc_act=True, seed=11)


@pytest.fixture(scope="module")
def port(ckpt):
    return AutoGPTQForCausalLM.from_quantized(ckpt, device="cpu", dtype=torch.float32)


@pytest.fixture(scope="module")
def ref(ckpt):
    return JaxAuto.from_quantized(ckpt, dtype=jnp.float32)


class Shim:
    def __init__(self, params, spec):
        self.params = params
        self.spec = spec


def _batch():
    """Two rows of 12 tokens, the second left-padded by 3: mask 0 and labels
    -100 on the pads."""
    tokens = np.random.default_rng(4).integers(0, VOCAB, (2, 12)).astype(np.int32)
    mask = np.ones_like(tokens)
    mask[1, :3] = 0
    labels = np.where(mask == 1, tokens, -100)
    return tokens, mask, labels


def masked_loss(logits, labels):
    """The example's loss: next-token NLL averaged over non-pad labels."""
    lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    tgt = labels[:, 1:].clamp_min(0)
    nll = -lp.gather(-1, tgt[..., None])[..., 0]
    m = (labels[:, 1:] != -100).float()
    return (nll * m).sum() / m.sum().clamp_min(1)


def jax_masked_loss(logits, labels):
    lp = jax.nn.log_softmax(logits[:, :-1].astype(jnp.float32), -1)
    tgt = jnp.maximum(labels[:, 1:], 0)
    nll = -jnp.take_along_axis(lp, tgt[:, :, None], axis=-1)[..., 0]
    m = (labels[:, 1:] != -100).astype(jnp.float32)
    return (nll * m).sum() / jnp.maximum(m.sum(), 1)


def _inject(kind, params, seed=0):
    if kind == "lora":
        return peft.inject_lora(params, peft.GPTQLoraConfig(r=4), seed)
    if kind == "adalora":
        return peft.inject_adalora(params, peft.GPTQLoraConfig(r=8, adalora=True), seed)
    return peft.inject_adaption_prompt(params, peft.AdaptionPromptConfig(4, 2), seed)


def _jax_inject(kind, params):
    if kind == "lora":
        return jpeft.inject_lora(params, jpeft.GPTQLoraConfig(r=4))
    if kind == "adalora":
        return jpeft.inject_adalora(params, jpeft.GPTQLoraConfig(r=8, adalora=True))
    return jpeft.inject_adaption_prompt(params, jpeft.AdaptionPromptConfig(4, 2))


def _set_nonzero(trainable, seed):
    """Every adapter leaf of a port trainable tree redrawn from NumPy (B, E
    and the gate become nonzero)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for t in peft.trainable_tensors(trainable):
            t.copy_(torch.from_numpy(np.asarray(rng.standard_normal(t.shape) * 0.1, np.float32)))


def _logits(params, cfg, tokens, mask=None):
    return arch.forward(params, torch.from_numpy(tokens).long(), cfg,
                        attn_mask=None if mask is None else torch.from_numpy(mask))[0]


def _train(params, cfg, steps, lr=1e-2):
    trainable, _ = peft.split_lora_params(params)
    opt = torch.optim.Adam(peft.trainable_tensors(trainable), lr=lr)
    tokens = np.random.default_rng(0).integers(0, VOCAB, (2, 16)).astype(np.int32)
    labels = torch.from_numpy(tokens).long()
    losses = []
    for _ in range(steps):
        loss = masked_loss(_logits(params, cfg, tokens), labels)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(loss.item())
    return losses


def test_find_all_linear_names(port):
    names = peft.find_all_linear_names(port.params)
    assert "attn.q_proj" in names and "mlp.down_proj" in names and len(names) == 7
    assert peft.find_all_linear_names(_inject("lora", port.params)) == names


def test_inject_and_forward_identity(port):
    """Fresh adapters (B = 0) do not change the forward."""
    tokens = np.arange(8, dtype=np.int32)[None]
    base = _logits(port.params, port.cfg, tokens)
    lparams = _inject("lora", port.params)
    node = lparams["layers"][0]["attn"]["q_proj"]
    assert isinstance(node, peft.LoraLinear) and isinstance(node.base, QuantLinear)
    assert node.lora_a.requires_grad and not node.lora_b.any()
    torch.testing.assert_close(_logits(lparams, port.cfg, tokens), base, rtol=1e-5, atol=1e-5)


def test_lora_training_reduces_loss(port):
    losses = _train(peft.inject_lora(port.params, peft.GPTQLoraConfig(r=8, lora_alpha=16)),
                    port.cfg, 30)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], f"loss did not decrease: {losses[0]} -> {losses[-1]}"


def test_adapter_save(port, tmp_path):
    lparams = peft.inject_lora(port.params, peft.GPTQLoraConfig(r=4,
                                                                target_modules=("attn.q_proj",)))
    peft.save_adapter(Shim(lparams, get_family("llama")), str(tmp_path))
    tensors = load_file(str(tmp_path / "adapter_model.safetensors"))
    assert len(tensors) == 2 * TINY["num_hidden_layers"]
    a = tensors["base_model.model.model.layers.0.self_attn.q_proj.lora_A.weight"]
    b = tensors["base_model.model.model.layers.0.self_attn.q_proj.lora_B.weight"]
    assert a.shape == (4, 128) and b.shape == (128, 4) and a.dtype == np.float32


def test_adalora_training_and_prune(port):
    lparams = _inject("adalora", port.params)
    tokens = np.arange(8, dtype=np.int32)[None]
    torch.testing.assert_close(_logits(lparams, port.cfg, tokens),
                               _logits(port.params, port.cfg, tokens), rtol=1e-5, atol=1e-5)
    trainable, _ = peft.split_lora_params(lparams)
    assert set(trainable["layers"][0]["attn"]["q_proj"]) == {"lora_a", "lora_e", "lora_b"}
    losses = _train(lparams, port.cfg, 20)
    assert losses[-1] < losses[0]
    pruned = peft.adalora_prune(lparams["layers"][0]["attn"]["q_proj"], 4)
    assert int(pruned.rank_mask.sum()) == 4


def test_adaption_prompt_identity_and_training(port):
    """Zero gate: an exact identity; 30 steps reduce the loss."""
    tokens = np.random.default_rng(1).integers(0, VOCAB, (2, 16)).astype(np.int32)
    lparams = _inject("adaption", port.params)
    assert all("adaption" in b["attn"] for b in lparams["layers"])
    torch.testing.assert_close(_logits(lparams, port.cfg, tokens),
                               _logits(port.params, port.cfg, tokens), rtol=1e-5, atol=1e-5)
    trainable, _ = peft.split_lora_params(lparams)
    assert set(trainable["layers"][1]["attn"]["adaption"]) == {"prompt", "gate"}
    losses = _train(lparams, port.cfg, 30)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("kind", KINDS)
def test_inject_does_not_mutate_original(port, kind):
    orig = port.params["layers"][0]["attn"]["q_proj"]
    lparams = _inject(kind, port.params)
    assert port.params["layers"][0]["attn"]["q_proj"] is orig
    assert "adaption" not in port.params["layers"][0]["attn"]
    assert lparams["layers"][0]["attn"] is not port.params["layers"][0]["attn"]


def test_lora_dropout_draws_from_the_generator(port):
    """Dropout only with an explicit generator: the same seed keeps the same
    entries, rate 0 or no generator is the plain adapter."""
    node = _inject("lora", port.params)["layers"][0]["attn"]["q_proj"]
    _set_nonzero({"x": node.lora_b}, seed=2)
    x = torch.randn(3, 128, generator=torch.Generator().manual_seed(0))
    plain = peft.apply_lora(node, x)
    torch.testing.assert_close(peft.apply_lora(node, x, torch.Generator(), 0.0), plain)

    def dropped(seed):
        return peft.apply_lora(node, x, torch.Generator().manual_seed(seed), 0.5)

    torch.testing.assert_close(dropped(1), dropped(1))
    assert not torch.allclose(dropped(1), dropped(2)) and not torch.allclose(dropped(1), plain)


def test_split_and_merge(port):
    """merge_lora_params writes a trainable tree's tensors back; the split
    tree's leaves are the model's own tensors."""
    lparams = _inject("adalora", port.params)
    trainable, same = peft.split_lora_params(lparams)
    assert same is lparams
    node = lparams["layers"][1]["attn"]["v_proj"]
    assert trainable["layers"][1]["attn"]["v_proj"]["lora_e"] is node.lora_e
    assert "mlp" not in trainable["layers"][0]
    new = {"layers": [{"attn": {p: {k: torch.full_like(t, 0.1) for k, t in leaves.items()}
                                for p, leaves in b["attn"].items()}}
                      for b in trainable["layers"]]}
    merged = peft.merge_lora_params(lparams, new)
    got = merged["layers"][1]["attn"]["v_proj"]
    assert isinstance(got, peft.AdaLoraLinear) and got.base is node.base
    assert float(got.lora_e[0]) == pytest.approx(0.1) and got.rank_mask is node.rank_mask
    assert lparams["layers"][1]["attn"]["v_proj"] is node
    tokens = np.arange(8, dtype=np.int32)[None]
    assert not torch.allclose(_logits(merged, port.cfg, tokens), _logits(lparams, port.cfg, tokens))


def test_inject_adalora_idempotent(port):
    """Re-injection (or AdaLoRA after LoRA) skips already wrapped nodes."""
    cfg = peft.GPTQLoraConfig(r=4, target_modules=("attn.q_proj",), adalora=True)
    p2 = peft.inject_adalora(peft.inject_adalora(port.params, cfg), cfg)
    node = p2["layers"][0]["attn"]["q_proj"]
    assert isinstance(node, peft.AdaLoraLinear) and isinstance(node.base, QuantLinear)
    p3 = peft.inject_adalora(peft.inject_lora(port.params, peft.GPTQLoraConfig(r=4)), cfg)
    assert isinstance(p3["layers"][0]["attn"]["q_proj"], peft.LoraLinear)


def test_adalora_adapter_save(port, tmp_path):
    """A/B/E with the rank mask folded into E; a model without LoRA/AdaLoRA
    adapters raises instead of writing an empty file."""
    cfg = peft.GPTQLoraConfig(r=4, target_modules=("attn.q_proj",), adalora=True)
    lparams = peft.inject_adalora(port.params, cfg)
    node = lparams["layers"][0]["attn"]["q_proj"]
    with torch.no_grad():
        node.lora_e.copy_(torch.tensor([1.0, 2.0, 3.0, 4.0]))
    lparams["layers"][0]["attn"]["q_proj"] = peft.adalora_prune(node, 2)
    peft.save_adapter(Shim(lparams, get_family("llama")), str(tmp_path / "ada"))
    tensors = load_file(str(tmp_path / "ada" / "adapter_model.safetensors"))
    e = tensors["base_model.model.model.layers.0.self_attn.q_proj.lora_E.weight"]
    assert e.shape == (4, 1)
    imp = peft.adalora_importance(node).numpy()
    np.testing.assert_array_equal(e[:, 0] != 0, imp >= np.sort(imp)[-2])
    assert any("lora_A" in n for n in tensors) and any("lora_B" in n for n in tensors)
    for params in (port.params, _inject("adaption", port.params)):
        with pytest.raises(ValueError, match="no LoRA/AdaLoRA"):
            peft.save_adapter(Shim(params, get_family("llama")), str(tmp_path / "none"))


def _both(ref, kind):
    """JAX params with adapters whose every leaf was redrawn with NumPy, and
    the same tree carried across to the port."""
    jp = _jax_inject(kind, ref.params)
    trainable, _ = jpeft.split_lora_params(jp)
    leaves, treedef = jax.tree_util.tree_flatten(trainable)
    rng = np.random.default_rng(KINDS.index(kind))
    leaves = [jnp.asarray(rng.standard_normal(np.shape(x)).astype(np.float32) * 0.1)
              for x in leaves]
    trainable = jax.tree_util.tree_unflatten(treedef, leaves)
    return jp, trainable, params_from_jax(jpeft.merge_lora_params(jp, trainable), device="cpu",
                                          dtype=torch.float32)


@pytest.mark.parametrize("kind", KINDS)
def test_logits_and_gradients_match_jax(ref, port, kind):
    """Logits of the left-padded batch to 1e-4, and every adapter gradient of
    the masked loss to 1e-4 relative (Frobenius), against ``jax.grad``."""
    jp, trainable, tparams = _both(ref, kind)
    tokens, mask, labels = _batch()

    def jloss(tr):
        p = jpeft.merge_lora_params(jp, tr)
        logits, _ = jarch.forward(p, jnp.asarray(tokens), ref.cfg, attn_mask=jnp.asarray(mask),
                                  backend="xla", dtype=jnp.float32)
        return jax_masked_loss(logits, jnp.asarray(labels)), logits

    (want_loss, want_logits), want_grads = jax.value_and_grad(jloss, has_aux=True)(trainable)
    logits = _logits(tparams, port.cfg, tokens, mask)
    valid = mask[:, :, None].astype(bool)
    np.testing.assert_allclose(np.where(valid, logits.detach().numpy(), 0),
                               np.where(valid, np.asarray(want_logits), 0), rtol=1e-4, atol=1e-4)
    loss = masked_loss(logits, torch.from_numpy(labels).long())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    got = peft.trainable_tensors(peft.split_lora_params(tparams)[0])
    want = jax.tree_util.tree_leaves(want_grads)
    assert len(got) == len(want) == len(jax.tree_util.tree_leaves(trainable))
    for t, w in zip(got, want):
        w = np.asarray(w)
        assert t.grad is not None and t.grad.shape == w.shape
        rel = np.linalg.norm(t.grad.numpy() - w) / np.linalg.norm(w)
        assert rel <= 1e-4, f"{tuple(w.shape)}: relative gradient error {rel:.2e}"


@pytest.mark.parametrize("kind", ["lora", "adalora"])
def test_save_adapter_matches_jax(ref, kind, tmp_path):
    jp, trainable, tparams = _both(ref, kind)
    merged = jpeft.merge_lora_params(jp, trainable)
    if kind == "adalora":     # a pruned node: the mask folded into E
        merged["layers"][1]["attn"]["v_proj"] = jpeft.adalora_prune(
            merged["layers"][1]["attn"]["v_proj"], 3)
        tparams["layers"][1]["attn"]["v_proj"] = peft.adalora_prune(
            tparams["layers"][1]["attn"]["v_proj"], 3)
    jpeft.save_adapter(Shim(merged, jget_family("llama")), str(tmp_path / "jax"))
    peft.save_adapter(Shim(tparams, get_family("llama")), str(tmp_path / "port"))
    want = load_file(str(tmp_path / "jax" / "adapter_model.safetensors"))
    got = load_file(str(tmp_path / "port" / "adapter_model.safetensors"))
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("kind", ["lora", "adaption"])
def test_generate_with_adapters_in_place(ckpt, kind):
    """Greedy tokens through the cache (K2's plain version for LoRA; the
    einsum path, with the prompt, for an adaption block) equal the argmax
    of the cache-less forward, step by step."""
    model = AutoGPTQForCausalLM.from_quantized(ckpt, device="cpu", dtype=torch.float32)
    cfg = peft.GPTQLoraConfig(r=4) if kind == "lora" else peft.AdaptionPromptConfig(4, 2)
    peft.get_gptq_peft_model(model, cfg, seed=1)
    _set_nonzero(peft.split_lora_params(model.params)[0], seed=5)
    prompt = np.random.default_rng(2).integers(1, VOCAB, (1, 6)).astype(np.int32)
    got = model.generate(prompt, max_new_tokens=6)
    seq = prompt
    with torch.no_grad():
        for _ in range(6):
            nxt = _logits(model.params, model.cfg, seq)[:, -1].argmax(-1).numpy()
            seq = np.concatenate([seq, nxt[:, None].astype(np.int32)], axis=1)
    np.testing.assert_array_equal(got, seq)


def test_beam_search_with_an_adaption_prompt_takes_the_contiguous_cache(ckpt):
    """The paged decode step has no adaption branch, so generate routes such
    a model to the contiguous-cache beam search."""
    model = AutoGPTQForCausalLM.from_quantized(ckpt, device="cpu", dtype=torch.float32)
    peft.get_gptq_peft_model(model, peft.AdaptionPromptConfig(4, 2), seed=1)
    _set_nonzero(peft.split_lora_params(model.params)[0], seed=6)
    prompt = np.random.default_rng(3).integers(1, VOCAB, (1, 5)).astype(np.int32)
    got = model.generate(prompt, max_new_tokens=4, num_beams=2)
    with torch.inference_mode():
        want = generation._generate_beam(model.params, torch.from_numpy(prompt),
                                         torch.ones((1, 5), dtype=torch.int32), model.cfg, 4, 0,
                                         None, 2, torch.float32)
    np.testing.assert_array_equal(got[:, 5:], want[:, 0].numpy())
