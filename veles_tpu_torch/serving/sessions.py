"""Wire encoding for exported decode sessions and tiered KV blocks.

The port's copy of ``veles_tpu/serving/sessions.py``, byte for byte in
what it produces: :meth:`DecodeScheduler.export_sessions` gives state
dicts with numpy leaves (the prompt, the per-layer K/V block contents;
the scheduler converts its tensors at that edge), and between replicas
they travel over the admin HTTP surface as JSON, arrays framed as
base64 raw bytes + dtype + shape — self-contained (no pickle: the peer
is a different process trusting only structured data).  A state
exported by either package imports into the other.

The same framing is the **tiered KV cache's** serialization format
(:mod:`veles_tpu_torch.kvtier`): one demoted KV block — the per-layer
K/V contents of a single content-addressed block — rides through
:func:`pack_block` / :func:`unpack_block` as canonical JSON bytes
(sorted keys, base64 raw data), so the bytes are a pure function of
the block contents: the disk tier's content-addressed chunk store
dedupes identical chains across sessions, restarts and packages.

Tier-resident blocks travel **by hash, not payload**: an exported
session whose leading blocks are published under prefix keys carries
them as a ``kv_hash`` list of chain-key hex digests and ships device
bytes only for the unpublished tail — the importer re-resolves the
hashes against its own pool and tier stack.
"""

import base64
import json

import numpy

__all__ = ["pack_state", "pack_states", "unpack_state", "unpack_states",
           "pack_block", "unpack_block", "HASH_FIELD"]

_ND = "__nd__"

#: state-dict field carrying chain-key hex digests of leading blocks
#: that travel by hash instead of payload (kvtier-enabled exports)
HASH_FIELD = "kv_hash"


def _encode(value):
    if isinstance(value, numpy.ndarray):
        # asarray(order="C"), NOT ascontiguousarray: the latter
        # promotes 0-d arrays to (1,), which breaks the shape-exact
        # round trip quantized scale leaves (a scalar per block) need
        a = numpy.asarray(value, order="C")
        return {_ND: base64.b64encode(a.tobytes()).decode("ascii"),
                "dtype": str(a.dtype), "shape": list(a.shape)}
    if isinstance(value, (list, tuple)):
        return [_encode(v) for v in value]
    if isinstance(value, dict):
        return {k: _encode(v) for k, v in value.items()}
    if isinstance(value, numpy.generic):
        return value.item()
    return value


def _decode(value):
    if isinstance(value, dict):
        if _ND in value:
            flat = numpy.frombuffer(
                base64.b64decode(value[_ND]),
                dtype=numpy.dtype(str(value["dtype"])))
            return flat.reshape([int(d) for d in value["shape"]]).copy()
        return {k: _decode(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_decode(v) for v in value]
    return value


def pack_state(state):
    """One exported session state → a JSON-safe dict."""
    return _encode(state)


def unpack_state(payload):
    """Inverse of :func:`pack_state` (arrays back to numpy)."""
    return _decode(payload)


def pack_states(states):
    return [pack_state(s) for s in states]


def unpack_states(payloads):
    return [unpack_state(p) for p in payloads]


def pack_block(payload):
    """One demoted KV block → canonical bytes for the tier stack.

    ``payload`` is a dict of numpy leaves (the per-layer K/V contents
    of a single block).  The result is deterministic for given block
    contents — sorted keys, raw-byte base64 — so content-addressing
    the bytes (sha256) dedupes identical chains across sessions,
    replicas and restarts.
    """
    return json.dumps(pack_state(payload), sort_keys=True,
                      separators=(",", ":")).encode("utf-8")


def unpack_block(data):
    """Inverse of :func:`pack_block` (bitwise: base64 of raw bytes)."""
    return unpack_state(json.loads(data.decode("utf-8")))
