"""Batched serving engine over fixed decode slots (port of
``src/repro/serve/engine.py``).

Requests are grouped into waves of ``slots``, left-padded to the wave's
longest prompt (pad token 0, which the models read like any token and
count in the positions, as in the reference); each wave prefills once and
decodes greedily (or samples)
until every member has emitted EOS or ``max_new_tokens`` are out.

A request's ``extras`` (``enc_frames``, ``vision_embeds``, ``positions3``)
are merged into its wave's prefill batch as the reference merges them:
one request after another, the last one's value of a key winning.  So
each extra must cover the whole wave: an extra whose batch axis (axis 1
of ``positions3``, axis 0 of the others) is not the wave's size raises a
``ValueError`` naming the shapes.  The reference goes on with it: its
Whisper raises a ``TypeError`` on such frames, and its vision stub
writes such embeddings into the rows they cover.

``rt`` (``models.transformer.Runtime``) is the mesh context every
prefill, decode and LM head of the engine runs under, as in the
reference: e.g. ``Runtime(mesh=..., split_kv_axis="model")`` decodes
split-KV.

Differences from the reference:

* ``temperature > 0`` samples from a ``torch.Generator`` seeded with
  ``seed``; it cannot reproduce ``jax.random``.  Greedy decoding is
  deterministic and is what the parity tests use.
* Each wave's host-clock timings are also kept in :attr:`Engine.waves`.
  They are the ``serve/prefill`` and ``serve/decode`` spans, which a
  ``tracer`` (``obs.Tracer``) records and the shared disabled tracer only
  times.  Both end points of each span are already host synchronisations
  (the sampled token is copied to the host for the EOS check), so no
  synchronisation is added for them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.model import Model
from repro_torch.models.transformer import Runtime
from repro_torch.obs import spans as obs_spans


@dataclasses.dataclass
class ServeConfig:
    slots: int = 4                # concurrent sequences (decode batch)
    max_len: int = 256            # cache capacity
    max_new_tokens: int = 32
    temperature: float = 0.0      # 0 = greedy
    eos_id: int = 2


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (S,) int32
    extras: dict | None = None    # enc_frames / vision stubs


BATCH_AXIS = {"positions3": 1}    # else 0: the batch axis of each extra


def _wave_batch(tokens: torch.Tensor, wave: list) -> dict:
    """The prefill batch of a wave: its tokens and its requests' extras,
    merged in order, on the tokens' device."""
    batch = {"tokens": tokens}
    for r in wave:
        for key, value in (r.extras or {}).items():
            if not isinstance(value, torch.Tensor):
                value = torch.from_numpy(np.asarray(value))
            axis = BATCH_AXIS.get(key, 0)
            if value.dim() <= axis or value.shape[axis] != len(wave):
                raise ValueError(
                    f"request {r.rid}: extra {key!r} of shape "
                    f"{tuple(value.shape)} has no batch axis {axis} of the "
                    f"wave's {len(wave)} requests (tokens "
                    f"{tuple(tokens.shape)})")
            batch[key] = value.to(tokens.device)
    return batch


@dataclasses.dataclass
class WaveStats:
    batch: int                    # requests in the wave
    prompt_len: int               # padded prompt length
    prefill_s: float              # prefill + first token, host clock
    decode_steps: int             # decode steps run
    decode_s: float               # all decode steps, host clock


class Engine:
    def __init__(self, model: Model, cfg: ServeConfig,
                 rt: Runtime | None = None, seed: int = 0,
                 tracer: obs_spans.Tracer | None = None):
        self.model = model
        self.rt = rt or Runtime()
        self.tracer = tracer if tracer is not None else obs_spans.NULL
        self.cfg = cfg
        self.seed = seed
        self.waves: list[WaveStats] = []
        self._generator: torch.Generator | None = None

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        last = logits[:, -1, :]
        if self.cfg.temperature <= 0:
            return last.argmax(dim=-1)
        if self._generator is None:
            self._generator = torch.Generator(device=last.device)
            self._generator.manual_seed(self.seed)
        probs = torch.softmax(last.float() / self.cfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self._generator)[:, 0]

    def generate_batch(self, params, requests: list) -> dict:
        """Serve a list of requests through fixed decode slots on the
        device of the parameters.  Returns {rid: np.ndarray of generated
        tokens (int32), up to and including the first EOS}."""
        device = params["embed"].device
        out: dict = {}
        slots = self.cfg.slots
        for w0 in range(0, len(requests), slots):
            wave = requests[w0:w0 + slots]
            B = len(wave)
            S = max(len(r.prompt) for r in wave)
            toks = np.zeros((B, S), np.int64)
            for j, r in enumerate(wave):
                toks[j, S - len(r.prompt):] = r.prompt    # left-pad
            batch = _wave_batch(torch.from_numpy(toks).to(device), wave)
            with self.tracer.span("serve/prefill", track="serve", batch=B,
                                  prompt_len=S) as pre:
                caches = self.model.init_caches(B, self.cfg.max_len,
                                                device=device)
                h, caches = self.model.prefill(params, batch, caches,
                                               self.rt)
                tok = self._sample(self.model.logits(params, h[:, -1:, :],
                                                     self.rt))
                gen = [tok.cpu().numpy()]
            done = np.zeros((B,), bool)
            with self.tracer.span("serve/decode", track="serve",
                                  batch=B) as dec:
                for _ in range(self.cfg.max_new_tokens - 1):
                    logits, caches = self.model.decode(params, caches,
                                                       tok[:, None], self.rt)
                    tok = self._sample(logits)
                    gen.append(tok.cpu().numpy())
                    done |= gen[-1] == self.cfg.eos_id
                    if done.all():
                        break
                dec.args["tokens"] = len(gen)
            self.waves.append(WaveStats(B, S, pre.dur_s, len(gen) - 1,
                                        dec.dur_s))
            g = np.stack(gen, axis=1).astype(np.int32)
            for j, r in enumerate(wave):
                seq = g[j]
                stop = np.where(seq == self.cfg.eos_id)[0]
                out[r.rid] = seq[: stop[0] + 1] if len(stop) else seq
        return out
