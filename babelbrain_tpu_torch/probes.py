"""Roofline and gather probes of the card, as CUDA kernels beside plain
PyTorch versions.

What the FDTD kernels can hope for on this card, measured with kernels built
like them (``csrc/probes.cu``, nvcc ``--fmad=false``):

* ``stream`` — y = x + 1 over 128 MB: the device-memory rate a streaming
  kernel reaches (the plain-XLA stream probe of
  ``tools/probe_roofline.py``);
* ``fma_chain`` — 8 dependent chains a = fma(a, 1.000001, x) per element of a
  (256, 512) block, ``rep`` times: the FP32 FMA rate, from two repetition
  counts differenced (P1 ``probe_vpu``);
* ``table_gather`` — out[r, e] = table[r, idx[e]], the table in shared
  memory: the indexed-material expansion of the viscoelastic kernels, on
  the 1026-entry CT table and the 16-entry label table over (2, 192, 240)
  slabs (P1 ``probe_gather``), on P2's (R, C, M) cases, and P2's cost probe
  at 960 x 192 indices into 1152 entries (``tools/probe_gather.py``).

``run_probes`` runs them all and returns their numbers; it is the entry
point, and runs on the card unless asked for the CPU (where the wrappers run
the plain versions and no time is taken). The wrappers dispatch on the
device of their inputs like every kernel wrapper of the port; ``launches``
and ``plain_calls`` count them.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import _build
from .ops.fdtd_kernels import _ptr

_KEYS = ("stream", "fma_chain", "table_gather")
launches = dict.fromkeys(_KEYS, 0)
plain_calls = dict.fromkeys(_KEYS, 0)

FMA_BLOCK = (256, 512)
FMA_CHAINS = 8
FMA_MUL = np.float32(1.000001)
# chain j starts at x * (1 + 0.01 j), rounded to float32 on the host
FMA_SCALE = np.float32(1.0) + np.float32(0.01) * np.arange(
    FMA_CHAINS, dtype=np.float32)
FMA_REPS = (1200, 4800)
STREAM_BYTES = 128 * 2**20
GATHER_SLAB = (2, 192, 240)
# P2's cases (R, C, M): its sublane (axis 0) and lane (axis 1) gathers are
# one kind of gather on this card
P2_CASES = ((8, 128, 8), (64, 128, 8), (64, 128, 64), (960, 192, 960),
            (960, 192, 1152), (1152, 192, 1152), (8, 128, 128),
            (64, 192, 128), (64, 192, 16), (64, 256, 256), (64, 1024, 1024))
P2_COST = (960, 192, 1152)
P2_REP = 50
# shared memory a block may take without an opt-in (the table's limit)
MAX_TABLE_FLOATS = 48 * 1024 // 4
GATHER_MAX_BLOCKS = 1056  # 8 blocks of 256 threads on each of 132 SMs


def _check(tensors, dtypes, what):
    dev = tensors[0].device
    for t, dt in zip(tensors, dtypes):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(
                f"{what}: expected contiguous {dt} on {dev}, got {t.dtype} on "
                f"{t.device}"
            )
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    return dev


def stream(x: torch.Tensor, out: torch.Tensor) -> None:
    """out = x + 1 (float32, any shape, same number of elements)."""
    dev = _check((x, out), (torch.float32,) * 2, "stream")
    if x.numel() != out.numel():
        raise ValueError("stream: x and out differ in size")
    if dev.type == "cpu":
        stream_ref(x, out)
        return
    if x.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("stream: the kernel moves 16-byte vectors; x and "
                         "out must be 16-byte aligned")
    _build.launch("bb_stream", "stream_kernel", dev, _ptr(x), _ptr(out),
                  x.numel())
    launches["stream"] += 1


def stream_ref(x: torch.Tensor, out: torch.Tensor) -> None:
    """Plain version of ``stream_kernel``."""
    plain_calls["stream"] += 1
    out.view(-1).copy_(x.view(-1) + 1.0)


def fma_chain(x: torch.Tensor, scale: torch.Tensor, out: torch.Tensor,
              rep: int) -> None:
    """out = sum_j a_j after ``rep`` steps a_j = fma(a_j, 1.000001, x) from
    a_j = x * scale[j] (``scale``: 8 floats)."""
    dev = _check((x, scale, out), (torch.float32,) * 3, "fma_chain")
    if scale.numel() != FMA_CHAINS or x.numel() != out.numel() or rep < 0:
        raise ValueError(f"fma_chain: {FMA_CHAINS} scales, out like x, rep >= 0")
    if dev.type == "cpu":
        fma_chain_ref(x, scale, out, rep)
        return
    _build.launch("bb_fma_chain", "fma_chain_kernel", dev, _ptr(x),
                  _ptr(scale), _ptr(out), x.numel(), int(rep))
    launches["fma_chain"] += 1


def fma_chain_ref(x: torch.Tensor, scale: torch.Tensor, out: torch.Tensor,
                  rep: int) -> None:
    """Plain version of ``fma_chain_kernel``: each fused multiply-add in
    float64, rounded once to float32. The float32 product is exact in
    float64, and so is the sum while the accumulators stay in [1, 2^23) and
    x in [1, 2) (49 significant bits at most), so the one rounding is the
    FMA's."""
    plain_calls["fma_chain"] += 1
    xf = x.view(1, -1)
    a = xf * scale.view(-1, 1)
    x64 = xf.double()
    mul = float(FMA_MUL)
    for _ in range(rep):
        a = (a.double() * mul + x64).float()
    o = a[0]
    for j in range(1, FMA_CHAINS):
        o = o + a[j]
    out.view(-1).copy_(o)


def table_gather(idx: torch.Tensor, table: torch.Tensor,
                 out: torch.Tensor) -> None:
    """out[r] = table[r, idx] for each row r of the (n_coef, M) table;
    ``idx`` int32 in [0, M) (not checked on the card), ``out`` (n_coef,) +
    idx.shape."""
    dev = _check((idx, table, out), (torch.int32, torch.float32,
                                     torch.float32), "table_gather")
    n_coef, m = table.shape
    if tuple(out.shape) != (n_coef,) + tuple(idx.shape):
        raise ValueError(f"table_gather: out {tuple(out.shape)} for a "
                         f"({n_coef}, {m}) table and idx {tuple(idx.shape)}")
    if not 1 <= n_coef * m <= MAX_TABLE_FLOATS:
        raise ValueError(f"table_gather: table of {n_coef * m} floats "
                         f"(1..{MAX_TABLE_FLOATS})")
    if dev.type == "cpu":
        table_gather_ref(idx, table, out)
        return
    n = idx.numel()
    if n == 0:
        return
    blocks = min((n + 255) // 256, GATHER_MAX_BLOCKS)
    _build.launch("bb_table_gather", "table_gather_kernel", dev, _ptr(idx),
                  _ptr(table), _ptr(out), n_coef, m, n, blocks)
    launches["table_gather"] += 1


def table_gather_ref(idx: torch.Tensor, table: torch.Tensor,
                     out: torch.Tensor) -> None:
    """Plain version of ``table_gather_kernel``."""
    plain_calls["table_gather"] += 1
    out.view(table.shape[0], -1).copy_(
        table.index_select(1, idx.view(-1)))


# ---------------------------------------------------------------------------
# the probes
# ---------------------------------------------------------------------------


def _timed_ms(fn, n, device, graph=False):
    """ms of one ``fn()`` on the card (CUDA events over ``n`` calls after a
    warm-up; with ``graph`` the calls are captured in one CUDA graph, so a
    launch shorter than the host's per-call work is timed alone); None on
    the CPU, where no device time exists."""
    if torch.device(device).type != "cuda":
        fn()
        return None
    run, calls_per_run = fn, 1
    if graph:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(n):
                fn()
        run, calls_per_run, n = g.replay, n, 5
    for _ in range(2):
        run()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        run()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n / calls_per_run


def gather_inputs(shape, m, n_coef, seed=0, device="cuda"):
    """(idx int32 ``shape`` in [0, m), table (n_coef, m) float32) from a
    seed."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, m, size=shape).astype(np.int32)
    tab = rng.standard_normal((n_coef, m)).astype(np.float32)
    dev = torch.device(device)
    return torch.as_tensor(idx, device=dev), torch.as_tensor(tab, device=dev)


def probe_stream(device="cuda", nbytes=STREAM_BYTES) -> dict:
    """GB/s of y = x + 1 over ``nbytes`` (read once, written once)."""
    n = nbytes // 4
    x = torch.zeros(n, dtype=torch.float32, device=device)
    y = torch.empty_like(x)
    ms = _timed_ms(lambda: stream(x, y), 20, device)
    ok = bool(torch.equal(y, x + 1.0))
    return {"probe": "stream", "bytes": int(nbytes), "exact": ok, "ms": ms,
            "GBps": None if ms is None else 2 * 4 * n / (ms * 1e-3) / 1e9}


def probe_fma(device="cuda", block=FMA_BLOCK, reps=FMA_REPS) -> dict:
    """FP32 GFLOP/s of the FMA chains (2 operations an FMA): from the
    difference of the two ``reps`` counts (each launch timed from a CUDA
    graph), and from the larger count alone (a lower bound, launch
    included); the kernel is held bit for bit to its plain version at the
    smaller count."""
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(1.0, 2.0, block).astype(np.float32),
                        device=device)
    scale = torch.as_tensor(FMA_SCALE, device=device)
    out = torch.empty_like(x)
    want = torch.empty_like(x)
    fma_chain(x, scale, out, reps[0])
    fma_chain_ref(x, scale, want, reps[0])
    ok = bool(torch.equal(out, want))
    # the two counts in turns, twice; the least time of each
    runs = [[_timed_ms(lambda r=r: fma_chain(x, scale, out, r), 10, device,
                       graph=True) for r in reps] for _ in range(2)]
    t = [None if None in ts else min(ts) for ts in zip(*runs)]
    res = {"probe": "fma_chain", "block": list(block), "reps": list(reps),
           "exact": ok, "ms": t, "GFLOPs": None, "GFLOPs_at_most_reps": None}
    if None not in t:
        flops = x.numel() * FMA_CHAINS * 2
        per_rep = (t[1] - t[0]) * 1e-3 / (reps[1] - reps[0])
        res["GFLOPs"] = flops / per_rep / 1e9
        res["GFLOPs_at_most_reps"] = flops * reps[1] / (t[1] * 1e-3) / 1e9
    return res


def probe_gather(device="cuda") -> list:
    """ns per gathered element of the CT (4 coefficients of 1026) and label
    (6 of 16) table expansions over a (2, 192, 240) slab, bit-exact against
    ``table[r][idx]`` (P1)."""
    res = []
    for name, n_coef, m in (("gather_ct", 4, 1026), ("gather_label", 6, 16)):
        idx, tab = gather_inputs(GATHER_SLAB, m, n_coef, device=device)
        out = torch.empty((n_coef,) + GATHER_SLAB, device=device)
        table_gather(idx, tab, out)
        ok = bool(torch.equal(out, tab[:, idx.long()]))
        ms = _timed_ms(lambda: table_gather(idx, tab, out), P2_REP, device,
                       graph=True)
        res.append({"probe": name, "exact": ok, "ms": ms,
                    "ns_per_elem": None if ms is None
                    else ms * 1e6 / (idx.numel() * n_coef)})
    return res


def probe_gather_cases(device="cuda", cases=P2_CASES, cost=P2_COST) -> dict:
    """P2: every (R, C, M) case bit-exact against ``table.reshape(-1)[idx]``,
    and the cost of one gather at ``cost`` = (R, C, M), timed from a CUDA
    graph of ``P2_REP`` launches."""
    bad = []
    for case in cases:
        r, c, m = case
        idx, tab = gather_inputs((r, c), m, 1, device=device)
        out = torch.empty((1, r, c), device=device)
        table_gather(idx, tab, out)
        if not torch.equal(out[0], tab.reshape(-1)[idx.long()]):
            bad.append(case)
    r, c, m = cost
    idx, tab = gather_inputs((r, c), m, 1, device=device)
    out = torch.empty((1, r, c), device=device)
    ms = _timed_ms(lambda: table_gather(idx, tab, out), P2_REP, device,
                   graph=True)
    return {"probe": "gather_cases", "cases": len(cases), "wrong": bad,
            "cost_case": list(cost), "ms": ms,
            "ns_per_elem": None if ms is None else ms * 1e6 / (r * c)}


def run_probes(device="cuda", small=False) -> list:
    """Every probe, in turn; ``small`` shrinks the shapes (a CPU test's
    size). Returns one dict per probe."""
    if small:
        return [probe_stream(device, nbytes=4096),
                probe_fma(device, block=(4, 8), reps=(2, 5)),
                *probe_gather(device),
                probe_gather_cases(device, cases=P2_CASES[:3],
                                   cost=(8, 128, 8))]
    return [probe_stream(device), probe_fma(device), *probe_gather(device),
            probe_gather_cases(device)]
