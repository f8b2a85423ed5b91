"""Faults planted on the wire of the port's data-parallel step, for the
contract tests (tests/test_torch_contracts.py).  Each wraps
``repro_torch.sharding.collectives.transport``: the lint's ranks install
it for the twin it names (``LintJob.wrap``), so the fault passes through
the wire log like any collective.  Imports only torch and the port."""
import functools

import torch

from repro_torch.sharding import collectives

# the factor dim of the reduced bert-large the bank faults ship
BANK_DIM = 256

# twin -> the faults its run carries
PLANTED = {
    "base@planted": ("unrounded",),
    "stale@planted": ("extra_bytes",),
    "health@planted": ("extra_collective",),
    "remap@planted": ("extra_collective",),
    "int8@planted": ("bank_every_step", "dequantized"),
}


class Faulty:
    """A transport that makes ``kinds`` of faults around ``inner``'s
    collectives (``inner`` records each call it makes)."""

    def __init__(self, inner, kinds):
        self.inner, self.kinds = inner, kinds

    def all_reduce(self, x, op=torch.distributed.ReduceOp.SUM):
        what, _ = collectives.wire_context()
        if "unrounded" in self.kinds and what == "stats":
            x.mul_(1 + 2 ** -12)           # no longer bf16-exact
        if "dequantized" in self.kinds and what == "owner_gather" and \
                x.dtype == torch.int8:
            return x.copy_(self.inner.all_reduce(x.float(), op=op))
        return self.inner.all_reduce(x, op=op)

    def reduce_scatter(self, out, x):
        self.inner.reduce_scatter(out, x)
        # once a step: the flat gradient's reduce-scatter
        if "extra_bytes" in self.kinds:
            self.inner.all_reduce(torch.zeros(16384, device=x.device))
        if "extra_collective" in self.kinds:
            self.inner.all_reduce(torch.zeros((), device=x.device))
        if "bank_every_step" in self.kinds:
            bank = torch.zeros((BANK_DIM, BANK_DIM), device=x.device)
            full = bank.new_empty((2 * BANK_DIM, BANK_DIM))
            self.inner.all_gather(full, bank)

    def all_gather(self, out, x):
        what, _ = collectives.wire_context()
        if "dequantized" in self.kinds and what == "owner_gather" and \
                x.dtype == torch.int8:
            full = torch.empty(out.shape, dtype=torch.float32,
                               device=out.device)
            self.inner.all_gather(full, x.float())
            out.copy_(full.to(torch.int8))
            return
        self.inner.all_gather(out, x)


def _wrap(kinds, transport):
    return lambda device: Faulty(transport(device), kinds)


def planted(twin):
    """``LintJob.wrap``: the faulty transport of a planted twin."""
    kinds = PLANTED.get(twin)
    return None if kinds is None else functools.partial(_wrap, kinds)
