"""A deterministic, KV-dependent decode stand-in: the serving tests' oracle.

The port of ``veles_tpu/serving/toydecode.py``.  Each next token is
integer arithmetic over the **cached** K/V contents, gathered through the
page table and masked by length (the access pattern of the ragged
paged-attention kernel), so

- generation is bitwise-deterministic and has a closed-form host oracle
  (:meth:`ToyDecodeModel.generate_reference`) in plain Python ints;
- a wrong page table, a clobbered block or a wrong length CHANGES THE
  OUTPUT: a model that ignored its cache would hide exactly the bugs
  prefix sharing and speculation can introduce;
- ``step_delay``, ``prefill_delay`` and ``draft_delay`` pin host time
  per step, per prompt token and per draft call (the scheduler sleeps
  them), so scheduling effects are measurable at no device cost.

The pools are torch int32 tensors on the model's device (``device=None``
is the card and raises without one; ``device="cpu"`` runs here), updated
in place like the flagship's.  Every intermediate stays far below 2**31
for contexts up to thousands of tokens, and the arithmetic is int32 as
in the JAX toy, so both packages emit the same tokens bit for bit.

Speculative decoding: the drafter replays the exact recurrence WITHOUT
writing the pools, then deterministically corrupts a tunable fraction
of its proposals (``draft_agreement``): acceptance-rate sweeps with no
model-quality noise.  Corruption costs acceptance, never correctness:
the verify pass recomputes every position from the cache.
"""

import numpy
import torch

from ..device import resolve_device

__all__ = ["ToyDecodeModel", "from_spec"]

#: mixing constants of the token recurrence (arbitrary small primes)
_A, _B, _C, _D = 31, 7, 13, 17

#: modulus/multipliers of the drafter's deterministic corruption hash
_AGREE_MOD, _AGREE_P1, _AGREE_P2 = 997, 403, 577


def _next_token(cache, last, vocab):
    """The recurrence both the device steps and the host oracle compute:
    token = f(sum of cached K, sum of cached V, last fed token, cache
    length)."""
    s1 = sum(cache)
    s2 = sum(3 * c + 1 for c in cache)
    return (s1 * _A + s2 * _B + last * _C + len(cache) * _D) % vocab


def _int32(x, device):
    """An int32 operand from the scheduler's numpy mirrors, a Python
    int or a tensor, on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32)
    return torch.tensor(numpy.asarray(x, numpy.int32), device=device)


def _masked_sum(x, mask):
    return torch.where(mask, x, 0).sum(dim=-1, dtype=torch.int32)


def _mix(s1, s2, last, count, vocab):
    return (s1 * _A + s2 * _B + last * _C + count * _D) % vocab


class ToyDecodeModel:
    """Decode adapter (``make_pools``/``prefill_fn``/``decode_fn``, plus
    ``prefill_chunk_fn`` and ``draft_fn``/``verify_fn``) whose K pool
    caches the token ids and whose V pool caches ``3*token+1``.

    ``kv_dtype="int8"`` swaps each int32 pool for {"q": int8, "s": f32
    per-block scales pinned at 1.0}.  Both pools then store the raw
    token id (lossless for vocab <= 128, ``3*token+1`` computed at read
    time), so int8 outputs are still exactly the host oracle's."""

    kind = "decode"
    #: KV-cache precisions the factories accept (scheduler protocol)
    kv_dtypes = ("f32", "int8")

    def __init__(self, vocab=97, step_delay=0.0, prefill_delay=0.0,
                 decode_defaults=None, draft_agreement=1.0,
                 draft_delay=0.0, device=None):
        self.device = resolve_device(device)
        self.vocab = int(vocab)
        if self.vocab < 2:
            raise ValueError("vocab must be >= 2")
        # the scheduler sleeps these: per step, per prompt token
        # actually prefilled (chunks pay only their own tokens), per
        # draft call (the drafter being cheaper than the target)
        self.step_host_delay = float(step_delay)
        self.prefill_host_delay = float(prefill_delay)
        self.draft_host_delay = float(draft_delay)
        self.draft_agreement = float(draft_agreement)
        if not 0.0 <= self.draft_agreement <= 1.0:
            raise ValueError("draft_agreement must be in [0, 1]")
        # geometry the registry applies when serving this model
        # (registry defaults < these < explicit kwargs)
        self.decode_defaults = dict(decode_defaults or {})

    def _kv(self, kv_dtype):
        dt = "f32" if kv_dtype is None else kv_dtype
        if dt not in self.kv_dtypes:
            raise ValueError("kv_dtype=%r not in %r"
                             % (dt, self.kv_dtypes))
        if dt == "int8" and self.vocab > 128:
            raise ValueError(
                "toydecode kv_dtype='int8' stores token ids as int8, "
                "so vocab must be <= 128 (got %d)" % self.vocab)
        return dt

    def make_pools(self, num_blocks, block_size, kv_dtype=None):
        shape = (int(num_blocks), int(block_size))
        dev = self.device
        if self._kv(kv_dtype) == "int8":
            def pool():
                return {"q": torch.zeros(shape, dtype=torch.int8,
                                         device=dev),
                        "s": torch.ones(shape[0], dtype=torch.float32,
                                        device=dev)}
            return ((pool(),), (pool(),))
        return ((torch.zeros(shape, dtype=torch.int32, device=dev),),
                (torch.zeros(shape, dtype=torch.int32, device=dev),))

    @staticmethod
    def _write(k, v, dest, off, kv_k, kv_v, q8):
        """Scatter K and V values into both pools (in place); int8
        pools store the token id (``kv_k``) in both."""
        dest, off = dest.long(), off.long()
        if q8:
            row = kv_k.to(torch.int8)
            k["q"].index_put_((dest, off), row)
            v["q"].index_put_((dest, off), row)
        else:
            k.index_put_((dest, off), kv_k)
            v.index_put_((dest, off), kv_v)

    @staticmethod
    def _gather(k, v, table, q8):
        """Each row's cache through its page table, flattened."""
        table = table.long()
        if q8:
            flat_k = k["q"][table].to(torch.int32)
            flat_v = 3 * flat_k + 1
        else:
            flat_k, flat_v = k[table], v[table]
        return (flat_k.reshape(*table.shape[:-1], -1),
                flat_v.reshape(*table.shape[:-1], -1))

    def prefill_fn(self, block_size, kv_dtype=None):
        bs, vocab, dev = int(block_size), self.vocab, self.device
        q8 = self._kv(kv_dtype) == "int8"

        def prefill(tokens, length, k_pools, v_pools, block_row):
            k, v = k_pools[0], v_pools[0]
            tokens = _int32(tokens, dev)
            block_row = _int32(block_row, dev)
            length = int(length)
            pos = torch.arange(tokens.shape[0], dtype=torch.int32,
                               device=dev)
            valid = pos < length
            nb = block_row.shape[0]
            dest = torch.where(
                valid, block_row[(pos // bs).clamp(max=nb - 1).long()], 0)
            kv_k = torch.where(valid, tokens, 0)
            kv_v = torch.where(valid, 3 * tokens + 1, 0)
            self._write(k, v, dest, pos % bs, kv_k, kv_v, q8)
            s1 = kv_k.sum(dtype=torch.int32)
            s2 = kv_v.sum(dtype=torch.int32)
            last = tokens[max(length - 1, 0)]
            return _mix(s1, s2, last, length, vocab), (k,), (v,)

        return prefill

    def prefill_chunk_fn(self, block_size, kv_dtype=None):
        bs, vocab, dev = int(block_size), self.vocab, self.device
        q8 = self._kv(kv_dtype) == "int8"

        def chunk(tokens, start, length, k_pools, v_pools, block_row):
            k, v = k_pools[0], v_pools[0]
            tokens = _int32(tokens, dev)
            block_row = _int32(block_row, dev)
            start, length = int(start), int(length)
            c = tokens.shape[0]
            pos = start + torch.arange(c, dtype=torch.int32, device=dev)
            valid = pos < length
            nb = block_row.shape[0]
            dest = torch.where(
                valid, block_row[(pos // bs).clamp(max=nb - 1).long()], 0)
            self._write(k, v, dest, pos % bs,
                        torch.where(valid, tokens, 0),
                        torch.where(valid, 3 * tokens + 1, 0), q8)
            # the sums run over the WHOLE cached prompt gathered through
            # the block row: the resident prefix is READ, not recomputed,
            # so a mutated or mismatched shared block changes the token
            flat_k, flat_v = self._gather(k, v, block_row, q8)
            mask = torch.arange(flat_k.shape[0], device=dev) < length
            s1 = _masked_sum(flat_k, mask)
            s2 = _masked_sum(flat_v, mask)
            last = tokens[min(max(length - 1 - start, 0), c - 1)]
            return _mix(s1, s2, last, length, vocab), (k,), (v,)

        return chunk

    def decode_fn(self, block_size, kv_dtype=None):
        bs, vocab, dev = int(block_size), self.vocab, self.device
        q8 = self._kv(kv_dtype) == "int8"

        def decode(k_pools, v_pools, page_table, lengths, tokens):
            k, v = k_pools[0], v_pools[0]
            table = _int32(page_table, dev)
            lengths = _int32(lengths, dev)
            tokens = _int32(tokens, dev)
            rows = torch.arange(tokens.shape[0], device=dev)
            # write the fed token at position `lengths` (padding rows
            # have lengths 0 and table row 0: the trash block)
            dest = table[rows, (lengths // bs).clamp(
                max=table.shape[1] - 1).long()]
            self._write(k, v, dest, lengths % bs, tokens, 3 * tokens + 1,
                        q8)
            flat_k, flat_v = self._gather(k, v, table, q8)
            count = lengths + 1          # the fed token is now cached
            mask = (torch.arange(flat_k.shape[1], device=dev)[None, :]
                    < count[:, None])
            s1 = _masked_sum(flat_k, mask)
            s2 = _masked_sum(flat_v, mask)
            return _mix(s1, s2, tokens, count, vocab), (k,), (v,)

        return decode

    def draft_fn(self, block_size, depth, kv_dtype=None):
        """Drafter: ``depth`` tokens a row by replaying the recurrence
        forward from the cache sums (pure reads), corrupted at ``1 -
        draft_agreement`` of positions by a hash of cache length and
        last token."""
        depth, vocab, dev = int(depth), self.vocab, self.device
        agree_cut = int(round(self.draft_agreement * _AGREE_MOD))
        q8 = self._kv(kv_dtype) == "int8"

        def draft(k_pools, v_pools, page_table, lengths, tokens):
            table = _int32(page_table, dev)
            lengths = _int32(lengths, dev)
            t = _int32(tokens, dev)
            flat_k, flat_v = self._gather(k_pools[0], v_pools[0], table,
                                          q8)
            mask = (torch.arange(flat_k.shape[1], device=dev)[None, :]
                    < lengths[:, None])
            s1 = _masked_sum(flat_k, mask)
            s2 = _masked_sum(flat_v, mask)
            proposals = []
            for i in range(depth):
                s1 = s1 + t
                s2 = s2 + 3 * t + 1
                cnt = lengths + 1 + i
                nxt = _mix(s1, s2, t, cnt, vocab)
                bucket = ((cnt % _AGREE_MOD) * _AGREE_P1
                          + (t % _AGREE_MOD) * _AGREE_P2) % _AGREE_MOD
                nxt = torch.where(bucket < agree_cut, nxt,
                                  (nxt + 1) % vocab)
                proposals.append(nxt)
                t = nxt
            return torch.stack(proposals, dim=1)

        return draft

    def verify_fn(self, block_size, depth, kv_dtype=None):
        """Target verify: write all ``depth + 1`` fed tokens, then the
        recurrence at EVERY fed position: ``out[:, i]`` is the plain
        decode's next token given the history plus fed tokens ``0 ..
        i``.  Writes past a row's blocks land in the trash block; writes
        past the accepted prefix are rolled back by not advancing the
        lengths.

        The history (positions before ``lengths``) is read back through
        the page table; the span's own tokens are summed as fed.  That
        is what the JAX toy reads back wherever the span lies in the
        row's blocks, and it stays defined where the span runs past
        them: there the JAX toy reads the shared trash block, whose
        content depends on the order other rows' writes land in."""
        bs, vocab, dev = int(block_size), self.vocab, self.device
        q8 = self._kv(kv_dtype) == "int8"

        def verify(k_pools, v_pools, page_table, lengths, tokens):
            k, v = k_pools[0], v_pools[0]
            table = _int32(page_table, dev)
            lengths = _int32(lengths, dev)
            tokens = _int32(tokens, dev)
            b, s = tokens.shape
            nb = table.shape[1]
            rows = torch.arange(b, device=dev)[:, None]
            pos = lengths[:, None] + torch.arange(s, dtype=torch.int32,
                                                  device=dev)[None, :]
            dest = torch.where(
                pos < nb * bs,
                table[rows, (pos // bs).clamp(max=nb - 1).long()], 0)
            self._write(k, v, dest, pos % bs, tokens, 3 * tokens + 1,
                        q8)
            flat_k, flat_v = self._gather(k, v, table, q8)
            history = (torch.arange(flat_k.shape[1], device=dev)[None, :]
                       < lengths[:, None])
            s1 = (_masked_sum(flat_k, history)[:, None]
                  + tokens.cumsum(dim=1, dtype=torch.int32))
            s2 = (_masked_sum(flat_v, history)[:, None]
                  + (3 * tokens + 1).cumsum(dim=1, dtype=torch.int32))
            return _mix(s1, s2, tokens, pos + 1, vocab), (k,), (v,)

        return verify

    def generate_reference(self, prompt, max_new_tokens):
        """Cache-free host oracle: the tokens an uninterrupted
        generation emits (plain Python ints)."""
        cache = [int(t) for t in prompt]
        if not cache:
            raise ValueError("empty prompt")
        out = [_next_token(cache, cache[-1], self.vocab)]
        while len(out) < int(max_new_tokens):
            cache.append(out[-1])
            out.append(_next_token(cache, out[-1], self.vocab))
        return out

    def __repr__(self):
        return ("ToyDecodeModel(vocab=%d, step_delay=%s, device=%s)"
                % (self.vocab, self.step_host_delay, self.device))


#: spec keys -> DecodeScheduler geometry kwargs
_GEOM_KEYS = {"max_batch": "max_batch", "block": "block_size",
              "max_prompt": "max_prompt_len", "max_new": "max_new_tokens",
              "num_blocks": "num_blocks", "queue_limit": "queue_limit",
              "chunk": "prefill_chunk_tokens", "prefix": "prefix_caching"}


def from_spec(spec, device=None):
    """``toydecode:key=value,...`` -> :class:`ToyDecodeModel` carrying
    its scheduler geometry in ``decode_defaults`` (vocab, delay, pdelay,
    ddelay and agree are model knobs; the rest are geometry).
    ``spec=K`` turns on speculative decoding at depth K.  The JAX
    package's keys all parse; ``spec=auto`` reaches the scheduler, which
    resolves it through the ``serving.spec_depth`` tuning site, and the
    ``tier_*`` keys its ``kvtier`` (``tier_disk=1``: the directory from
    ``VELES_KVTIER_DIR``)."""
    body = spec.partition(":")[2]
    vocab, delay, pdelay, ddelay, agree = 97, 0.0, 0.0, 0.0, 1.0
    defaults = {}
    for part in filter(None, body.split(",")):
        key, _, value = part.partition("=")
        key = key.strip()
        if key == "vocab":
            vocab = int(value)
        elif key == "delay":
            delay = float(value)
        elif key == "pdelay":
            pdelay = float(value)
        elif key == "ddelay":
            ddelay = float(value)
        elif key == "agree":
            agree = float(value)
        elif key == "spec":
            defaults["spec_depth"] = ("auto" if value.strip() == "auto"
                                      else int(value))
        elif key == "tier_host":
            defaults.setdefault("kvtier", {})["host_bytes"] = int(value)
        elif key == "tier_disk":
            v = value.strip()
            if v != "0":
                defaults.setdefault("kvtier", {})["disk_dir"] = \
                    True if v == "1" else v
        elif key == "tier_disk_bytes":
            defaults.setdefault("kvtier", {})["disk_bytes"] = int(value)
        elif key == "kv_dtype":
            v = value.strip()
            if v not in ToyDecodeModel.kv_dtypes:
                raise ValueError("toydecode kv_dtype=%r (want one of "
                                 "%s)" % (v, ", ".join(
                                     ToyDecodeModel.kv_dtypes)))
            if v != "f32":
                defaults["kv_dtype"] = v
        elif key in _GEOM_KEYS:
            defaults[_GEOM_KEYS[key]] = int(value)
        else:
            raise ValueError("unknown toydecode spec key %r (want "
                             "vocab, delay, pdelay, ddelay, agree, "
                             "spec, tier_host, tier_disk, "
                             "tier_disk_bytes, kv_dtype, %s)"
                             % (key, ", ".join(sorted(_GEOM_KEYS))))
    return ToyDecodeModel(vocab=vocab, step_delay=delay,
                          prefill_delay=pdelay, draft_delay=ddelay,
                          draft_agreement=agree,
                          decode_defaults=defaults, device=device)
