"""GPTQModel: quantize, save, load and generate, on the card by default.

Counterpart of the JAX package's ``models/base.py``:

* ``from_pretrained`` loads an unquantized HF checkpoint into dense params;
* ``quantize`` runs GPTQ layer by layer: the embedding runs once, then each
  block is folded over the cached hidden states, capturing the input of
  every linear (``arch.block_forward(capture=...)``), accumulating Hessians,
  solving each sublist of ``spec.quant_layers`` in ``true_sequential`` order
  (q/k/v and gate/up, which share a Hessian, as one N-concatenated solve) and
  re-running the block with the quantized weights before moving on. The
  re-forward goes through :func:`ops.quantlinear.matmul`, so on the card it
  launches the dequant-matmul kernels;
* ``save_quantized`` / ``from_quantized`` write and read the GPTQ checkpoint
  format (safetensors + ``quantize_config.json`` + ``config.json``);
* ``generate`` decodes greedily, by temperature sampling, or by beam search.

Not ported yet, each raising ``NotImplementedError``: resuming ``quantize``
from a ``checkpoint_dir``, quantizing the ``lm_head``, ``push_to_hub``, and
the AWQ and Marlin checkpoint formats (ROADMAP Queue 1,
'The rest of quantization, and checkpoint I/O').
"""

from __future__ import annotations

import contextlib
import copy
import json
import logging
import os
import time
from collections import defaultdict
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops import quantlinear as qlin
from ..quantization import (BaseQuantizeConfig, GPTQConfig, gptq_quantize, hessian_init,
                            hessian_update)
from ..utils import hf_io
from . import arch, params as params_lib
from .arch import ArchConfig
from .registry import FamilySpec, get_family

logger = logging.getLogger(__name__)

QUANTIZER_NAME = "autogptq_tpu_torch:0.1.0"     # the safetensors "quantizer" metadata


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; asking for CUDA without a card raises instead
    of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} was requested but no CUDA device is "
                           "available; pass device='cpu' to run the plain PyTorch path")
    return dev


def _check_solver_loss(total_loss, where: str) -> float:
    """Surface a non-finite GPTQ solver loss (a Hessian that is not positive
    definite) at once instead of packing NaN weights."""
    loss = float(total_loss)
    if not np.isfinite(loss):
        raise ValueError(
            f"GPTQ solver produced a non-finite loss for {where}: the Hessian is likely "
            "not positive definite. Increase damp_percent or provide more/denser "
            "calibration data.")
    return loss


def _pad_examples(examples: Sequence[dict], pad_token_id: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Left-pad a list of ``{"input_ids"}`` dicts to a common length; the
    attention mask is 0 on the pads."""
    ids = [np.asarray(e["input_ids"]).reshape(-1) for e in examples]
    max_len = max(len(x) for x in ids)
    batch = np.full((len(ids), max_len), pad_token_id, dtype=np.int32)
    mask = np.zeros((len(ids), max_len), dtype=np.int32)
    for i, x in enumerate(ids):
        batch[i, max_len - len(x):] = x
        mask[i, max_len - len(x):] = 1
    return batch, mask


class PhaseTimer:
    """Host-clock seconds per named phase. On a CUDA device each phase ends
    with a synchronize, so the device work it enqueued is charged to it."""

    def __init__(self, device: torch.device):
        self.device = device
        self.seconds: dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.seconds[name] += time.perf_counter() - t0


def _share_hessian(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two Hessians are the same matrix, compared where they lie: the
    diagonals first, the full matrices only when those match."""
    return (a.shape == b.shape and torch.equal(torch.diagonal(a), torch.diagonal(b))
            and torch.equal(a, b))


def _copy_section(v):
    """A block section's dict copied down to its lists of expert dicts."""
    if not isinstance(v, dict):
        return v
    return {k: [dict(e) for e in x] if isinstance(x, list) else x for k, x in v.items()}


class GPTQModel:
    """A causal LM whose linear layers are, or are about to be, GPTQ-quantized."""

    def __init__(self, params: dict, cfg: ArchConfig, spec: FamilySpec,
                 quantize_config: BaseQuantizeConfig, device: torch.device,
                 dtype: torch.dtype, quantized: bool = True):
        self.params = params
        self.cfg = cfg
        self.spec = spec
        self.quantize_config = quantize_config
        self.device = device
        self.dtype = dtype
        self.quantized = quantized
        # "{layer}.{path}" -> PackedQuantLinear (checkpoint layout) after quantize()
        self.packed_layers: dict[str, qlin.PackedQuantLinear] = {}
        # filled by quantize(): seconds per phase, per-linear solver losses
        self.quantize_stats: dict = {}

    # ------------------------------------------------------------------
    # Constructors
    # ------------------------------------------------------------------

    @classmethod
    def from_pretrained(cls, model_dir: str, quantize_config: Optional[BaseQuantizeConfig] = None,
                        device="cuda", dtype: torch.dtype = torch.bfloat16) -> "GPTQModel":
        """Load a local unquantized HF checkpoint directory (``config.json``,
        safetensors) onto ``device``, ready for :meth:`quantize`."""
        dev = resolve_device(device)
        hf_cfg = hf_io.load_hf_config(model_dir)
        spec = get_family(hf_cfg["model_type"], hf_cfg)
        cfg = spec.arch_fn(hf_cfg)
        tensors = hf_io.open_tensors(model_dir)
        params = params_lib.build_fp_params(tensors, spec, cfg, dtype=dtype, device=dev)
        qc = quantize_config or BaseQuantizeConfig()
        qc.model_name_or_path = model_dir
        return cls(params, cfg, spec, qc, dev, dtype, quantized=False)

    @classmethod
    def from_quantized(cls, model_dir: str, device="cuda", dtype: torch.dtype = torch.bfloat16,
                       layout: Optional[str] = None) -> "GPTQModel":
        """Load a local GPTQ checkpoint directory (``config.json``,
        ``quantize_config.json``, safetensors) onto ``device``. ``layout``
        ``"kb32l"`` loads every quantized linear into the tile-contiguous
        layout of K6 (3- and 4-bit checkpoints whose group size divides 256),
        as the JAX package's ``from_packed(layout="kb32l")``; the default keeps
        GPTQ's words (K1/K4/K5)."""
        dev = resolve_device(device)
        hf_cfg = hf_io.load_hf_config(model_dir)
        spec = get_family(hf_cfg["model_type"], hf_cfg)
        cfg = spec.arch_fn(hf_cfg)
        qc = BaseQuantizeConfig.from_pretrained(model_dir)
        if qc.checkpoint_format != "gptq":
            raise NotImplementedError(
                f"checkpoint format {qc.checkpoint_format!r} is not ported yet (AWQ and "
                "Marlin conversions: ROADMAP Queue 1, 'The rest of quantization, and checkpoint "
                "I/O'); only 'gptq' checkpoints load")
        qc.model_name_or_path = model_dir
        tensors = hf_io.open_tensors(model_dir, qc.model_file_base_name)
        params = params_lib.build_quantized_params(
            tensors, spec, cfg, qc.bits, qc.group_size, dtype=dtype, device=dev, layout=layout)
        return cls(params, cfg, spec, qc, dev, dtype)

    # ------------------------------------------------------------------
    # Quantization
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def quantize(self, examples: Sequence[dict], batch_size: int = 1,
                 calib_dtype: torch.dtype = torch.float32,
                 checkpoint_dir: Optional[str] = None) -> None:
        """Run GPTQ calibration over ``examples`` (a list of ``{"input_ids"}``).

        Per decoder block and per sublist of ``spec.quant_layers``: one capture
        pass per batch accumulates the Hessians, each group of layers that
        share a Hessian is solved once, the solved layers are packed and
        swapped in, and the block is re-run with its quantized weights to give
        the next block's inputs. Only one block's captures and Hessians are
        alive at a time. ``quantize_stats`` keeps the seconds per phase
        (hessian, solver, pack, reforward) and the per-linear solver losses."""
        if self.quantized:
            raise RuntimeError("model is already quantized")
        qc = self.quantize_config
        if checkpoint_dir is not None:
            raise NotImplementedError("resuming quantize() from a checkpoint_dir is not ported "
                                      "yet (ROADMAP Queue 1, 'The rest of quantization, and "
                                      "checkpoint I/O')")
        if qc.lm_head:
            raise NotImplementedError("quantizing the lm_head (quantize_config.lm_head) is not "
                                      "ported yet (ROADMAP Queue 1, 'The rest of quantization, "
                                      "and checkpoint I/O')")
        if qc.quant_method != "gptq" or qc.checkpoint_format != "gptq":
            raise NotImplementedError(
                f"quant method {qc.quant_method!r} / checkpoint format "
                f"{qc.checkpoint_format!r}: only GPTQ checkpoints are produced (AWQ and "
                "Marlin: ROADMAP Queue 1, 'The rest of quantization, and checkpoint I/O')")
        cfg, spec, dev = self.cfg, self.spec, self.device
        if dev.type == "cuda":     # refuse a shape no kernel takes before any solve
            for k, n in {tuple(params_lib.get_in(self.params["layers"][0], p).kernel.shape)
                         for sub in spec.quant_layers for p in sub}:
                qlin.check_card_shape(qc.bits, k, n, qc.group_size)

        gcfg = GPTQConfig(bits=qc.bits, group_size=qc.group_size, sym=qc.sym,
                          desc_act=qc.desc_act, static_groups=qc.static_groups,
                          percdamp=qc.damp_percent, mse=qc.mse)

        # Batch and embed all examples once.
        hidden, masks, positions = [], [], []
        for i in range(0, len(examples), batch_size):
            tokens, mask = _pad_examples(examples[i:i + batch_size])
            pos = np.maximum(np.cumsum(mask, axis=-1) - 1, 0)
            hidden.append(arch.embed(self.params, torch.from_numpy(tokens).long().to(dev),
                                     calib_dtype))
            masks.append(torch.from_numpy(mask).to(dev))
            positions.append(torch.from_numpy(pos).to(dev))

        quant_sublists = spec.quant_layers
        if not qc.true_sequential:
            quant_sublists = [[p for sub in spec.quant_layers for p in sub]]

        timer = PhaseTimer(dev)
        losses: dict[str, float] = {}
        t_start = time.perf_counter()

        for li, block in enumerate(self.params["layers"]):
            # a copy whose sections (and expert lists) we mutate as sublists quantize
            block = {k: _copy_section(v) for k, v in block.items()}
            for sublist in quant_sublists:
                hs: dict = {}
                with timer.phase("hessian"):
                    for bi in range(len(hidden)):
                        caps: dict = {}
                        arch.block_forward(block, hidden[bi], 0, None, positions[bi], cfg,
                                           masks[bi], capture=caps)
                        for p in sublist:
                            x_in = caps[p]
                            if p not in hs:
                                hs[p] = hessian_init(x_in.shape[-1], dev)
                            hs[p] = hessian_update(hs[p][0], hs[p][1], x_in)
                        del caps

                # q/k/v (and gate/up) see the same activations, so their
                # Hessians are identical: solve each such group as one
                # N-concatenated matrix (the solver is row-independent given
                # H), running the serial per-column loop once.
                groups: list[list[str]] = []
                for p in sublist:
                    for grp in groups:
                        if _share_hessian(hs[p][0], hs[grp[0]][0]):
                            grp.append(p)
                            break
                    else:
                        groups.append([p])

                for grp in groups:
                    nodes = [params_lib.get_in(block, p) for p in grp]
                    rows = np.cumsum([0] + [nd.kernel.shape[1] for nd in nodes])
                    where = f"layer {li} {'+'.join(grp)}"
                    with timer.phase("solver"):
                        w = torch.cat([nd.kernel.t().float() for nd in nodes], dim=0)
                        res = gptq_quantize(w, hs[grp[0]][0], gcfg)
                        del w
                        _check_solver_loss(res.total_loss, where)
                        row_loss = res.row_loss.cpu().numpy()
                    with timer.phase("pack"):
                        for gi, (p, node) in enumerate(zip(grp, nodes)):
                            r0, r1 = int(rows[gi]), int(rows[gi + 1])
                            losses[f"{li}.{p}"] = float(row_loss[r0:r1].sum())
                            bias = None if node.bias is None else node.bias.float().cpu().numpy()
                            packed = qlin.pack_from_solver(
                                res.qweight[r0:r1], res.scale[:, r0:r1], res.zero[:, r0:r1],
                                res.g_idx, bits=qc.bits, group_size=qc.group_size, bias=bias)
                            self.packed_layers[f"{li}.{p}"] = packed
                            params_lib.set_in_block(
                                block, p, qlin.from_packed(packed, device=dev, dtype=self.dtype))
                    del res
                    for p in grp:
                        del hs[p]
                logger.info("layer %d/%d sublist %s quantized", li + 1, cfg.num_layers, sublist)

            with timer.phase("reforward"):
                for bi in range(len(hidden)):
                    hidden[bi] = arch.block_forward(block, hidden[bi], 0, None, positions[bi],
                                                    cfg, masks[bi])
            self.params["layers"][li] = block

        seconds = time.perf_counter() - t_start
        self.quantize_stats = dict(seconds=seconds, phases=dict(timer.seconds), losses=losses)
        logger.info("quantized %d layers in %.1fs (mean solver loss %.4f)", cfg.num_layers,
                    seconds, float(np.mean(list(losses.values()))) if losses else float("nan"))
        self.quantized = True

    # ------------------------------------------------------------------
    # Save
    # ------------------------------------------------------------------

    def save_quantized(self, save_dir: str, safetensors_metadata: Optional[dict] = None,
                       max_shard_size: Optional[int] = None,
                       hf_config: Optional[dict] = None) -> None:
        """Write a GPTQ checkpoint: single or sharded safetensors named after
        ``model_file_base_name`` (``gptq_model-{bits}bit-{group_size}g`` by
        default), ``quantize_config.json`` and ``config.json`` with
        ``quantization_config`` embedded."""
        if not self.quantized:
            raise RuntimeError("save_quantized only saves quantized models")
        if not self.packed_layers:
            raise NotImplementedError("saving a model that from_quantized loaded is not ported "
                                      "yet: save_quantized needs the packed layers of quantize()")
        qc = self.quantize_config
        os.makedirs(save_dir, exist_ok=True)
        tensors = params_lib.flatten_quantized_params(self.params, self.packed_layers,
                                                      self.spec, self.cfg)
        model_base = qc.model_file_base_name or f"gptq_model-{qc.bits}bit-{qc.group_size}g"
        qc.model_file_base_name = model_base
        meta = dict(safetensors_metadata or {})
        meta.setdefault("format", "pt")
        meta["gptq_bits"] = str(qc.bits)
        meta["gptq_group_size"] = str(qc.group_size)
        meta["gptq_desc_act"] = str(qc.desc_act)
        meta["gptq_damp_percent"] = str(qc.damp_percent)
        meta["quantizer"] = QUANTIZER_NAME
        hf_io.save_safetensors(tensors, os.path.join(save_dir, f"{model_base}.safetensors"),
                               metadata={k: str(v) for k, v in meta.items()},
                               max_shard_size=max_shard_size)
        qc.save_pretrained(save_dir)
        if hf_config is None and qc.model_name_or_path:
            try:
                hf_config = hf_io.load_hf_config(qc.model_name_or_path)
            except FileNotFoundError:
                hf_config = None
        if hf_config is not None:
            hf_config = copy.deepcopy(hf_config)
            hf_config["quantization_config"] = qc.to_dict()
            with open(os.path.join(save_dir, "config.json"), "w") as f:
                json.dump(hf_config, f, indent=2)

    def push_to_hub(self, *args, **kwargs) -> None:
        raise NotImplementedError("push_to_hub is not ported (ROADMAP Queue 1, 'The rest of "
                                  "quantization, and checkpoint I/O'); "
                                  "save_quantized writes a local directory")

    # ------------------------------------------------------------------
    # Inference
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def forward(self, tokens, attn_mask=None) -> torch.Tensor:
        """Full-sequence forward -> logits ``[B, T, V]`` (f32) on the device."""
        tokens = torch.as_tensor(tokens).long().to(self.device)
        if tokens.dim() == 1:
            tokens = tokens[None]
        mask = None if attn_mask is None else torch.as_tensor(attn_mask).to(self.device)
        return arch.forward(self.params, tokens, self.cfg, attn_mask=mask, dtype=self.dtype)[0]

    __call__ = forward

    def generate(self, input_ids, max_new_tokens: int = 128, temperature: float = 0.0,
                 num_beams: int = 1, eos_token_id: Optional[int] = None,
                 min_new_tokens: int = 0, seed: int = 0, pad_token_id: int = 0,
                 kv_quant: bool = False, length_penalty: float = 1.0,
                 early_stopping=False, num_return_sequences: int = 1,
                 draft_model: Optional["GPTQModel"] = None, speculative_gamma: int = 4,
                 phased: bool = True) -> np.ndarray:
        """Returns ``[B * num_return_sequences, T_in + max_new_tokens]`` token
        ids (see :func:`autogptq_tpu_torch.utils.generation.generate`).

        ``draft_model`` enables speculative decoding (greedy, batch 1,
        :func:`autogptq_tpu_torch.utils.speculative.generate_speculative`):
        token-identical to plain greedy, faster when the draft agrees."""
        from ..utils import generation

        if draft_model is not None:
            if num_beams > 1 or (temperature and temperature > 0):
                raise ValueError("speculative decoding is greedy-only")
            if min_new_tokens or kv_quant or num_return_sequences > 1:
                raise ValueError(
                    "speculative decoding does not support min_new_tokens, "
                    "kv_quant, or num_return_sequences"
                )
            from ..utils.speculative import generate_speculative

            return generate_speculative(
                self, draft_model, input_ids, max_new_tokens=max_new_tokens,
                gamma=speculative_gamma, eos_token_id=eos_token_id)
        return generation.generate(
            self, input_ids, max_new_tokens=max_new_tokens, temperature=temperature,
            num_beams=num_beams, eos_token_id=eos_token_id, min_new_tokens=min_new_tokens,
            seed=seed, pad_token_id=pad_token_id, kv_quant=kv_quant,
            length_penalty=length_penalty, early_stopping=early_stopping,
            num_return_sequences=num_return_sequences, phased=phased,
        )


__all__ = ["GPTQModel", "PhaseTimer", "resolve_device"]
