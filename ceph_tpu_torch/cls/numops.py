"""cls_numops: atomic arithmetic on omap values.

Reference parity: src/cls/numops/cls_numops.cc — add/mul a stored
number by a client-supplied operand in one OSD-side step (subtract and
divide are client-sugar: add(-x), mul(1/x)).  Running on the OSD makes
counter updates safe under concurrent writers without a lock.

State: the number lives as a decimal string in omap[key] (exactly the
reference's representation, so plain omap reads interop).  Errors:
-EBADMSG when the stored value isn't a number, -EOVERFLOW when the
result doesn't fit a finite float (the reference checks strtod
overflow the same way).

The port's copy of ``ceph_tpu.cls.numops``.
"""

from __future__ import annotations

import errno
import json
import math

from ceph_tpu_torch.cls import ClsContext, cls_method


def _apply(hctx: ClsContext, inbl: bytes, op) -> tuple:
    req = json.loads(inbl.decode())
    key = req["key"].encode()
    try:
        operand = float(req["value"])
    except (TypeError, ValueError):
        return -errno.EINVAL, b""
    stored = hctx.omap_get_values([key]).get(key)
    if stored is None:
        current = 0.0
    else:
        try:
            current = float(stored.decode())
        except ValueError:
            return -errno.EBADMSG, b""
    result = op(current, operand)
    if math.isinf(result) or math.isnan(result):
        return -errno.EOVERFLOW, b""
    # integers round-trip without a trailing .0 so external readers
    # (and the reference's strtod) parse them cleanly
    text = repr(int(result)) if result == int(result) else repr(result)
    hctx.omap_set({key: text.encode()})
    return 0, b""


@cls_method("numops.add", writes=True)
def numops_add(hctx: ClsContext, inbl: bytes):
    """in: {key, value} — omap[key] += value (missing key counts 0)."""
    return _apply(hctx, inbl, lambda a, b: a + b)


@cls_method("numops.mul", writes=True)
def numops_mul(hctx: ClsContext, inbl: bytes):
    """in: {key, value} — omap[key] *= value."""
    return _apply(hctx, inbl, lambda a, b: a * b)
