"""The invariants of the persistent SMW kernel's launch plan
(``src/repro_torch/csrc/smw_plan.cuh``), held on the C entries of a library
built from it: the CPU tests build the header alone with a host compiler,
the cuda tests use the kernel's own library.  Imports no JAX."""
import ctypes

# kTileBytes, kMaxTileRows and kTicketsHeld in smw_plan.cuh
TILE_BYTES, MAX_TILE_ROWS, TICKETS_HELD = 32 << 10, 32, 4


def bind(lib):
    """Sets the argument types of the plan's two C entries on ``lib``."""
    lib.mkor_block_smw_plan.argtypes = [ctypes.c_int] * 4 + [
        ctypes.c_longlong, ctypes.c_void_p]
    lib.mkor_block_smw_plan.restype = None
    lib.mkor_block_smw_ticket.argtypes = [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    lib.mkor_block_smw_ticket.restype = None
    return lib


def plan(lib, batch, d, rank, item, resident):
    """The plan the C code makes: rows, tiles, run, runs, lag."""
    out = (ctypes.c_int * 5)()
    lib.mkor_block_smw_plan(d, batch, rank, item, resident, out)
    return dict(zip(("rows", "tiles", "run", "runs", "lag"), out))


def check_plan(lib, batch, d, rank, item, resident):
    """Tiles cover the rows within the shared buffer and runs cover the
    tiles within MAX_TILE_ROWS rows; the tickets, as the C decoder names
    them, hold every run of every slice once in each pass, each pass in
    order; a slice's write runs all come after its last pass-1 run, more
    tickets after it than the ``resident`` blocks hold at once (or the
    passes run one after the other).  Returns the plan."""
    p = plan(lib, batch, d, rank, item, resident)
    n = batch * p["runs"]
    assert 1 <= p["rows"] <= MAX_TILE_ROWS
    assert p["rows"] * d * item <= TILE_BYTES or p["rows"] == 1
    assert (p["tiles"] - 1) * p["rows"] < d <= p["tiles"] * p["rows"]
    assert p["run"] * p["rows"] <= MAX_TILE_ROWS
    assert (p["runs"] - 1) * p["run"] < p["tiles"] <= p["runs"] * p["run"]
    assert p["lag"] == min(n, p["runs"] + TICKETS_HELD * resident)

    out, seen = (ctypes.c_int * 3)(), {}
    for t in range(2 * n):
        lib.mkor_block_smw_ticket(t, batch, p["runs"], p["lag"], out)
        key = tuple(out)
        assert key not in seen, key
        seen[key] = t
    every = [(s, i) for s in range(batch) for i in range(p["runs"])]
    for phase in (0, 1):
        order = sorted((t, s, i) for (ph, s, i), t in seen.items()
                       if ph == phase)
        assert [(s, i) for _, s, i in order] == every
    for s in range(batch):
        last_p1 = seen[(0, s, p["runs"] - 1)]
        first_wr = seen[(1, s, 0)]
        if p["lag"] < n:
            assert first_wr - last_p1 > TICKETS_HELD * resident
        else:
            assert first_wr >= n > last_p1
    return p
