"""Cache-key construction (§3).

PyTorch twin of ``repro.core.keys``. A key identifies a one-hop sub-query
instance: ``(template id, root vertex id, wildcard values of P^e, wildcard
values of P^l)``. Template id and root stay explicit in the cache slots;
the parameter vector is reduced to a 32-bit fingerprint plus an
independently seeded 32-bit slot hash (both held as int64, see
``repro_torch.utils.helpers``).
"""

from __future__ import annotations

import torch

from repro_torch.core.templates import MAX_CONDS
from repro_torch.utils import hash_rows

PARAM_LEN = 2 * MAX_CONDS  # P^e wildcards then P^l wildcards

_SEED_SLOT = 0x51ED5EED
_SEED_FP = 0xF1A9F00D


def make_param_vec(pe_wild_vals, pl_wild_vals):
    """Concatenate wildcard value vectors into the key's parameter vector."""
    return torch.cat([pe_wild_vals, pl_wild_vals], dim=-1)


def _cols(tpl_id, root, params):
    root = torch.as_tensor(root).to(torch.int32)
    tpl = torch.as_tensor(tpl_id, dtype=torch.int32, device=root.device)
    cols = [tpl.expand(root.shape), root]
    for i in range(PARAM_LEN):
        cols.append(params[..., i])
    return cols


def key_slot_hash(tpl_id, root, params):
    """uint32 slot-selection hash of the full key tuple (as int64)."""
    return hash_rows(_cols(tpl_id, root, params), _SEED_SLOT)


def key_fingerprint(tpl_id, root, params):
    """uint32 fingerprint of the full key tuple (as int64)."""
    return hash_rows(_cols(tpl_id, root, params), _SEED_FP)
