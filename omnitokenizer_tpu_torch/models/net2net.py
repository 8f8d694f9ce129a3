"""Net2NetTransformer: tokenizer codes -> token ids -> GPT, the conditioning
encoders, the training loss and the generation entry points (mirror of
`omnitokenizer_tpu.models.net2net`; the reference's lm_transformer.py and
modules/encoders.py).

    n2n = Net2NetTransformer(cfg, tokenizer)            # GPT on the tokenizer's device
    sample = n2n.make_class_conditional_sampler(1024, top_k=2048, bucket=256)
    ids = sample(classes, torch.Generator("cuda").manual_seed(0))
    pixels = n2n.decode_to_pixels(ids, is_image=True)
    loss, metrics = n2n.loss_fn(n2n.encode_to_z(pixels, True), classes)

Vocabulary layout: [sos?][condition vocab][codebook], so the code ids are
offset by `z_offset`.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import Net2NetConfig
from ..ops.int8 import quantize_gpt_decode_params
from .gpt import GPT, init_weights, make_cfg_sampler, make_sampler
from .wrapper import OmniTokenizerVQGAN


def labelator_encode(labels: torch.Tensor) -> torch.Tensor:
    """Class ids (B,) -> the token column (B, 1)."""
    return torch.as_tensor(labels).reshape(-1, 1).long()


def sos_encode(batch: int, sos_token: int = 0, device="cpu") -> torch.Tensor:
    return torch.full((batch, 1), sos_token, dtype=torch.long, device=device)


class Net2NetTransformer:
    """An LM over a frozen tokenizer's codes. `gpt` holds the f32 master
    weights; without one, a GPT at minGPT's init from `seed` on the
    tokenizer's device."""

    def __init__(self, cfg: Net2NetConfig, tokenizer: OmniTokenizerVQGAN,
                 gpt: Optional[GPT] = None, seed: int = 0,
                 cond_stage_model: Optional[OmniTokenizerVQGAN] = None):
        if cfg.unconditional and cfg.starts_with_sos:
            # the reference forces starts_with_sos off when unconditional: the
            # sos token 0 is prepended anyway but shares id space with code 0
            # (no vocab slot, no +1 offset)
            cfg = cfg.replace(starts_with_sos=False)
        self.cfg = cfg
        self.tokenizer = tokenizer
        # a second tokenizer for 'stft' conditioning
        self.cond_stage_model = cond_stage_model
        if gpt is None:
            gpt = GPT(cfg.gpt)
            init_weights(gpt, torch.Generator().manual_seed(seed))
        self.gpt = gpt.to(tokenizer.device).eval()

    @property
    def device(self) -> torch.device:
        return self.tokenizer.device

    # -- vocabulary ---------------------------------------------------------
    @property
    def cond_vocab(self) -> int:
        return 0 if self.cfg.unconditional else self.cfg.class_cond_dim

    @property
    def z_offset(self) -> int:
        return self.cond_vocab + (1 if self.cfg.starts_with_sos else 0)

    # -- token pipeline -----------------------------------------------------
    def encode_to_z(self, x, is_image: bool) -> torch.Tensor:
        """Pixels (channels-first) -> flat codebook ids (B, N)."""
        enc = self.tokenizer.encode(x, is_image)
        if self.cfg.sample_every_n_latent_frames > 0:
            enc = enc[:, ::self.cfg.sample_every_n_latent_frames]
        return enc.reshape(enc.shape[0], -1).long()

    def encode_to_c(self, cond, is_image: bool = True) -> torch.Tensor:
        """A condition -> its token column(s): 'label' class ids (B,), 'text'
        token ids (B, L) as they are, 'stft' a second tokenizer's flat codes."""
        key = self.cfg.cond_stage_key
        if self.cfg.unconditional:
            return sos_encode(len(cond), self.cfg.sos_token, self.device)
        if key == "label":
            return labelator_encode(cond).to(self.device)
        if key == "text":
            cond = torch.as_tensor(cond, device=self.device)
            return cond.reshape(cond.shape[0], -1).long()
        if key == "stft":
            if self.cond_stage_model is None:
                raise ValueError("stft conditioning needs cond_stage_model")
            enc = self.cond_stage_model.encode(cond, is_image)
            return enc.reshape(enc.shape[0], -1).long()
        raise NotImplementedError(key)

    def build_sequence(self, z_ids: torch.Tensor, labels):
        """(cz_indices, targets, prefix_len) of the reference's training
        sequence; `labels` are class ids (B,) or condition columns (B, L)."""
        cfg = self.cfg
        B = z_ids.shape[0]
        dev = z_ids.device
        z = z_ids.long() + self.z_offset
        if cfg.unconditional:
            c = sos_encode(B, cfg.sos_token, dev)
            return torch.cat([c, z], dim=1), z_ids, c.shape[1] - 1
        labels = torch.as_tensor(labels, device=dev)
        c = labels.reshape(B, -1).long() if labels.ndim > 1 else labelator_encode(labels)
        if cfg.starts_with_sos:
            c = c + 1
            sos = sos_encode(B, cfg.sos_token, dev)
            cz = torch.cat([c, sos, z] if cfg.class_first else [sos, c, z], dim=1)
            return cz, z_ids, c.shape[1]
        return torch.cat([c, z], dim=1), z_ids, c.shape[1] - 1

    # -- training loss ------------------------------------------------------
    def draw_pkeep(self, shape, generator: Optional[torch.Generator] = None,
                   device=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """The draws of the pkeep corruption: a keep mask (True with
        probability cfg.pkeep) and random ids in [0, vocab_size), each of
        `shape`, from `generator` (the JAX loss draws them from its key)."""
        device = device if device is not None else self.device
        keep = torch.rand(shape, generator=generator, device=device) < self.cfg.pkeep
        rand = torch.randint(0, self.cfg.gpt.vocab_size, shape, generator=generator,
                             device=device)
        return keep, rand

    def loss_fn(self, z_ids: torch.Tensor, labels, keep: Optional[torch.Tensor] = None,
                rand_ids: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, {loss, acc1, acc5}) of the GPT on a batch of codebook ids
        z_ids (B, N) and its condition (class ids (B,) or columns (B, L)):
        cross-entropy of the logits past the prefix against the targets, the
        top-1 and top-5 accuracies in percent. With cfg.pkeep < 1 and the
        draws given (`draw_pkeep`), each offset id whose `keep` is False is
        replaced by its `rand_ids` entry; as in the JAX loss, the corrupted
        ids are the targets too."""
        inputs, target, prefix = self.loss_inputs(z_ids, labels, keep, rand_ids)
        logits, _ = self.gpt(inputs)
        return self.loss_from_logits(logits, target, prefix)

    def loss_inputs(self, z_ids: torch.Tensor, labels, keep: Optional[torch.Tensor] = None,
                    rand_ids: Optional[torch.Tensor] = None):
        """(the GPT's input tokens (B, T), the targets, the prefix length)
        of loss_fn, the pkeep corruption applied."""
        off = self.z_offset
        z_in = z_ids
        if keep is not None and self.cfg.pkeep < 1.0:
            z_in = torch.where(keep, z_ids.long() + off, rand_ids.long()) - off
        cz, target, prefix = self.build_sequence(z_in, labels)
        if cz.shape[1] - 1 > self.cfg.gpt.block_size:
            raise ValueError(
                f"the sequence is {cz.shape[1]} tokens ({cz.shape[1] - z_ids.shape[1]} of "
                f"sos and condition, {z_ids.shape[1]} codes); the GPT reads all but the last: "
                f"block_size {self.cfg.gpt.block_size} < {cz.shape[1] - 1}")
        return cz[:, :-1], target, prefix

    def loss_from_logits(self, logits: torch.Tensor, target: torch.Tensor, prefix: int
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """loss_fn's loss and metrics from the GPT's logits (B, T, V)."""
        logits = logits[:, prefix:]
        target = target.long() + self.z_offset
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), target.reshape(-1))
        with torch.no_grad():
            acc1 = (logits.argmax(-1) == target).float().mean() * 100
            top5 = logits.topk(5, dim=-1).indices
            acc5 = (top5 == target[..., None]).any(-1).float().mean() * 100
        return loss, {"loss": loss.detach(), "acc1": acc1, "acc5": acc5}

    # -- generation ---------------------------------------------------------
    def _serving(self, int8: bool):
        """(gpt_cfg, quant): int8 turns on the W8A8 decode path with the
        quantized weights (ops/int8.py), built here from the f32 masters."""
        if not int8:
            return self.cfg.gpt, None
        return self.cfg.gpt.replace(int8_decode=True), quantize_gpt_decode_params(self.gpt)

    def _clamp(self, toks: torch.Tensor) -> torch.Tensor:
        return torch.clamp(toks - self.z_offset, 0, self.cfg.first_stage_vocab_size - 1)

    def make_class_conditional_sampler(self, steps: int, temperature: float = 1.0,
                                       top_k: Optional[int] = None, top_p: float = 1.0,
                                       cfg_ratio: float = 1.5, use_cfg: bool = True,
                                       scale_cfg: bool = True, bucket: Optional[int] = None,
                                       int8: bool = False, cuda_graphs: bool = True
                                       ) -> Callable:
        """sample(cls_ids (B,), generator) -> codebook ids (B, steps), clamped
        into the codebook as the reference's transformer_eval does. With
        `use_cfg` (and a sos token) the CFG sampler; `scale_cfg` grows the
        guidance with the step, the reference's default. `sample.fn` is the
        GPT sampler (its segment timing)."""
        cfg = self.cfg
        gpt_cfg, quant = self._serving(int8)
        if use_cfg and cfg.starts_with_sos:
            fn = make_cfg_sampler(gpt_cfg, steps, temperature, top_k, top_p, cfg_ratio=cfg_ratio,
                                  class_first=cfg.class_first, scale_cfg=scale_cfg,
                                  bucket=bucket, cuda_graphs=cuda_graphs)

            def sample(cls_ids, generator=None):
                cls_ids = torch.as_tensor(cls_ids, device=self.device).reshape(-1, 1)
                return self._clamp(fn(self.gpt, cls_ids, generator, quant=quant))
        else:
            fn = make_sampler(gpt_cfg, steps, temperature, top_k, top_p, bucket=bucket,
                              cuda_graphs=cuda_graphs)

            def sample(cls_ids, generator=None):
                cls_ids = torch.as_tensor(cls_ids, device=self.device)
                if cfg.unconditional:
                    prefix = sos_encode(cls_ids.shape[0], cfg.sos_token, self.device)
                else:
                    prefix = labelator_encode(cls_ids)
                return self._clamp(fn(self.gpt, prefix, generator, quant=quant))
        sample.fn = fn
        return sample

    def decode_to_pixels(self, ids, is_image: bool) -> torch.Tensor:
        return self.tokenizer.decode(ids, is_image)

    def make_frame_prediction_sampler(self, total_latent_frames: int,
                                      prefix_latent_frames: int = 2,
                                      temperature: float = 1.0, top_k: Optional[int] = None,
                                      top_p: float = 1.0, bucket: Optional[int] = None,
                                      int8: bool = False, cuda_graphs: bool = True) -> Callable:
        """sample(video (B, C, T, H, W), generator) -> the id grid (B, t, h, w):
        the video's first `prefix_latent_frames` latent frames as encoded,
        the rest continued by the LM."""
        hw = self.tokenizer.cfg.latent_hw
        steps = (total_latent_frames - prefix_latent_frames) * hw * hw
        gpt_cfg, quant = self._serving(int8)
        fn = make_sampler(gpt_cfg, steps, temperature, top_k, top_p, bucket=bucket,
                          cuda_graphs=cuda_graphs)

        def sample(video, generator=None):
            z = self.encode_to_z(video, is_image=False) + self.z_offset
            prefix_len = prefix_latent_frames * hw * hw
            prefix = z[:, :prefix_len]
            if self.cfg.starts_with_sos or self.cfg.unconditional:
                sos = sos_encode(z.shape[0], self.cfg.sos_token, z.device)
                prefix = torch.cat([sos, prefix], dim=1)
            cont = self._clamp(fn(self.gpt, prefix, generator, quant=quant))
            full = torch.cat([z[:, :prefix_len] - self.z_offset, cont], dim=1)
            return full.reshape(z.shape[0], total_latent_frames, hw, hw)

        sample.fn = fn
        return sample
