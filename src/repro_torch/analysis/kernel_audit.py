"""Pass 2 — kernel audit of every registered entry point of the datapath
kernels, and of whole runs of the resident-pool datapath on the card.

The counterpart of the JAX package's jaxpr audit. A jaxpr does not exist
in PyTorch, and the CUDA kernels are ``ctypes`` launches
(:mod:`repro_torch.kernels._build`) that a dispatch mode cannot see, so each
rule reads the call as it runs:

- ``KERN001`` (``JAX001``) — exactly the declared launches of the port's
  kernels per entry; the fused round is ONE launch. Counted on the card
  from the kernel events of a ``torch.profiler`` window, by kernel name
  (:func:`port_kernel`), and from the wrappers' launch counts. A CPU run
  launches no kernel: there the rule is reported as not run, never as
  passed.
- ``KERN002`` (``JAX002``) — no pool-sized copy or allocation. A
  ``TorchDispatchMode`` records every aten op of the call: ``cat``,
  ``pad``, ``constant_pad_nd``, ``clone``, ``copy`` or ``_to_copy`` of the
  pool is a finding, and so is any new tensor of at least the pool's
  elements that is also larger than every other operand (at the
  registry's small cases the ``[B, S]`` stream outgrows the pool, and a
  tensor of its size is O(batch) work, not a copy of the pool). The
  in-place write of the pool itself (``index_put_`` on a view of it) is no
  new tensor. On the card, also the allocator's peak over the call (its
  requested bytes, not the rounded ones) less the bytes of the outputs it
  returns must stay below the pool's bytes.
- ``KERN003`` (``JAX003``) — no silent int64: every output and the pool
  stay int32. On the card, also no int64 device tensor larger than an
  index over the call's (or round's) pages, rows x pages a row: an int64
  index of O(rows), such as ``DevicePool._index`` (one int64 row id per
  row a round touches), is PyTorch's indexing idiom. The plain versions'
  int64 index tensors on the CPU (``kernels/ref.py``: the clamped table
  lookups, the flat scatter positions, the rule index) are the same idiom
  and are not flagged.
- ``KERN004`` (``JAX004``) — the declared boundary budget: the elements of
  the call's tensor arguments (keyword operands included) plus its
  outputs. On the card, also no ``Memcpy HtoD`` / ``DtoH`` inside the
  call: its operands are resident, so a wrapper that syncs or copies is a
  finding.
- ``KERN005`` (``JAX005``) — the round updates the pool in place: the
  returned pool is the input's storage (``data_ptr``) and both hold what
  the plain version computes on a copy of the pool.

An entry may name rules it must raise (``expect``): the negative control
``selective_copy[cloned-pool]`` runs the call on a pool-sized copy of the
pool, made inside the audited call, and the audit fails if ``KERN002`` (and
``KERN005``: the input is left as it was) do not fire, so the registry
shows that it can fail.

:func:`audit_rounds` holds a whole ``ProxyRuntime.run()`` over a resident
CUDA pool to the same rules and to the pool's ``xfer`` counters: the
kernels' profiler events against the round counters, the boundary bytes of
every ``Memcpy`` against the tokens ``xfer`` counts (and, where a crossing
is not counted, a ``KERN004`` finding at the line that makes it), the peak
allocation against the pool's bytes, the pool's storage and the widest
int64 device tensor.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import re
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function, schedule
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.analysis.common import Finding, Report, apply_waivers, \
    scan_waivers
from repro_torch.core.device_pool import DevicePool
from repro_torch.kernels import attention, mlstm_scan, ops, selective_copy
from repro_torch.kernels.testing import (fused_round_case, policy_case,
                                         policy_live_column,
                                         policy_payload_case, selcopy_case,
                                         selcopy_crypto_case, selgather_case,
                                         to_torch)

REPO_ROOT = Path(__file__).resolve().parents[3]
PKG_DIR = Path(__file__).resolve().parents[1]
ANALYSIS_DIR = Path(__file__).resolve().parent

#: aten ops that, applied to the pool, copy it
POOL_COPY_OPS = frozenset({"cat", "pad", "constant_pad_nd", "clone", "copy",
                           "copy_", "_to_copy"})
#: the port's kernels, as their wrappers count them (``LAUNCHES``)
PORT_KERNELS = ("selective_copy", "selective_gather", "policy_match",
                "fused_round", "paged_attention", "flash_attention",
                "mlstm_scan")
#: ``<kernel>_kernel`` in a profiler kernel name, demangled or not
_KERNEL_RE = re.compile(r"(?<![A-Za-z_])(" + "|".join(PORT_KERNELS)
                        + r")_kernel")

#: pause that opens a profiler window, and the label of the marker kernel
#: after it that must be seen: a window can lose its first device activity
WINDOW_PAUSE_S = 0.2
WINDOW_MARKER_LABEL = "kernel_audit.window_marker"
ROUNDS_LABEL = "kernel_audit.rounds"

#: boundary crossings the pool's ``xfer`` counters count, by the function
#: that makes them: int32 uploads through ``TokenPool._upload``
#: (``h2d_tokens``) and int32 downloads of device rows, gathered payloads
#: and fused verdicts (``d2h_tokens``). ``DevicePool._index`` uploads int64
#: row ids that no counter holds; :func:`audit_rounds` counts them itself.
COUNTED_H2D = frozenset({("src/repro_torch/core/stream.py", "_upload")})
INDEX_H2D = ("src/repro_torch/core/device_pool.py", "_index")
COUNTED_D2H = frozenset({
    ("src/repro_torch/core/device_pool.py", "_materialize_rows"),
    ("src/repro_torch/core/device_pool.py", "fused_round_device"),
    ("src/repro_torch/core/device_pool.py", "gather_batch_device"),
})


def port_kernel(name: str) -> Optional[str]:
    """The port kernel a profiler kernel event's name belongs to, or None
    for any other kernel (PyTorch's own, a marker)."""
    m = _KERNEL_RE.search(name)
    return m.group(1) if m else None


def launch_findings(loc: str, kernel_names: Sequence[str],
                    expected: Dict[str, int],
                    launched: Optional[Dict[str, int]] = None
                    ) -> List[Finding]:
    """KERN001: the port's kernels among ``kernel_names`` (profiler kernel
    events), counted by kernel, must equal ``expected`` (a kernel it does
    not name: 0), and so must the wrappers' launch counts ``launched``
    where given."""
    seen = dict.fromkeys(PORT_KERNELS, 0)
    for n in kernel_names:
        k = port_kernel(n)
        if k is not None:
            seen[k] += 1
    findings = []
    for k in PORT_KERNELS:
        want = expected.get(k, 0)
        if seen[k] != want:
            findings.append(Finding(
                loc, 0, "KERN001",
                f"{seen[k]} {k} kernel event(s), expected {want}"
                + (" — the fused round regressed" if k == "fused_round"
                   else "")))
        if launched is not None and launched.get(k, 0) != want:
            findings.append(Finding(
                loc, 0, "KERN001",
                f"{launched.get(k, 0)} {k} launch(es) counted by its "
                f"wrapper, expected {want}"))
    return findings


# -- the aten ops a call runs ------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TensorInfo:
    """What the audit keeps of a tensor: never the tensor itself."""
    storage: int
    numel: int
    dtype: torch.dtype
    device: str

    @property
    def nbytes(self) -> int:
        return self.numel * self.dtype.itemsize


def info(t: torch.Tensor) -> TensorInfo:
    return TensorInfo(t.untyped_storage().data_ptr(), t.numel(), t.dtype,
                      t.device.type)


@dataclasses.dataclass
class OpCall:
    name: str
    ins: List[TensorInfo]
    outs: List[TensorInfo]
    #: (file, line, function) of the port's code that ran a cross-device
    #: copy; None for other ops
    site: Optional[Tuple[str, int, str]] = None


def _tensors(x) -> List[torch.Tensor]:
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


def _site() -> Tuple[str, int, str]:
    """The innermost frame of the port's package (outside this one)."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if fn.startswith(str(PKG_DIR)) and not fn.startswith(
                str(ANALYSIS_DIR)):
            return (str(Path(fn).relative_to(REPO_ROOT)), f.f_lineno,
                    f.f_code.co_name)
        f = f.f_back
    return ("<outside the package>", 0, "?")


class OpRecorder(TorchDispatchMode):
    """Records every aten op run inside it: name, inputs and outputs as
    :class:`TensorInfo`, and for a copy between devices the line of the
    port's code that asked for it."""

    def __init__(self):
        super().__init__()
        self.ops: List[OpCall] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = [info(t) for t in _tensors((args, kwargs))]
        outs = [info(t) for t in _tensors(out)]
        site = None
        if {t.device for t in ins} != {t.device for t in outs} and outs:
            site = _site()
        self.ops.append(OpCall(func.overloadpacket.__name__, ins, outs, site))
        return out


def pool_copy_findings(loc: str, ops: Sequence[OpCall], pool: TensorInfo,
                       operands: Sequence[TensorInfo], floor: int
                       ) -> List[Finding]:
    """KERN002 from the dispatch record: an op of :data:`POOL_COPY_OPS`
    reading the pool into new storage, or a new tensor (storage that none
    of ``operands`` has) of at least ``floor`` elements."""
    known = {t.storage for t in operands}
    findings, flagged = [], set()
    for op in ops:
        reads_pool = any(t.storage == pool.storage and t.numel
                         for t in op.ins)
        for t in op.outs:
            if t.storage in known or t.storage in flagged or not t.numel:
                continue
            if op.name in POOL_COPY_OPS and reads_pool:
                flagged.add(t.storage)
                findings.append(Finding(
                    loc, 0, "KERN002",
                    f"pool copied by aten.{op.name} into a new tensor of "
                    f"{t.numel} elements"))
            elif t.numel >= floor:
                flagged.add(t.storage)
                findings.append(Finding(
                    loc, 0, "KERN002",
                    f"pool-sized allocation: aten.{op.name} made a tensor of "
                    f"{t.numel} elements (the pool has {pool.numel})"))
    return findings


def wide_int_findings(loc: str, ops: Sequence[OpCall], bound: int
                      ) -> Tuple[List[Finding], int]:
    """KERN003 on the card: int64 device tensors of more than ``bound``
    elements; returns the findings and the widest int64 device tensor."""
    widest, findings = 0, []
    for op in ops:
        for t in op.outs:
            if t.dtype == torch.int64 and t.device == "cuda":
                widest = max(widest, t.numel)
                if t.numel > bound:
                    findings.append(Finding(
                        loc, 0, "KERN003",
                        f"int64 device tensor of {t.numel} elements from "
                        f"aten.{op.name}, above the index bound {bound}"))
    return findings, widest


# -- one audited call ----------------------------------------------------------

@dataclasses.dataclass
class Call:
    """One audited call, ``fn(*args, **kwargs)``. ``pool`` is the index of
    the pool among ``args`` and ``pool_out`` that of the returned pool
    among the results (None: the call takes or returns no pool);
    ``plain`` computes what the pool must hold after the call (run on a
    copy of it). ``declared`` is the entry's boundary budget in elements,
    ``kernel`` the port kernel it launches once, ``index_bound`` the
    widest int64 index it may make (rows x pages a row). ``clone_pool``
    makes the call run on a copy of the pool taken inside the audited
    region (the negative control); ``expect`` names rules that must
    fire."""
    name: str
    fn: Callable
    args: tuple
    kwargs: dict = dataclasses.field(default_factory=dict)
    kernel: Optional[str] = None
    declared: Optional[int] = None
    pool: Optional[int] = None
    pool_out: Optional[int] = None
    plain: Optional[Callable] = None
    index_bound: int = 0
    clone_pool: bool = False
    expect: Tuple[str, ...] = ()

    @property
    def loc(self) -> str:
        return f"<kernels:{self.name}>"

    def run(self):
        args = list(self.args)
        if self.clone_pool:
            args[self.pool] = args[self.pool].clone()
        return self.fn(*args, **self.kwargs)

    def plain_pool(self) -> Optional[torch.Tensor]:
        """The pool the plain version leaves, computed on a copy."""
        if self.plain is None or self.pool_out is None:
            return None
        args = list(self.args)
        args[self.pool] = args[self.pool].clone()
        return self.plain(*args, **self.kwargs)[self.pool_out]


def audit_call(call: Call, card: bool = False,
               region: Callable = contextlib.nullcontext
               ) -> Tuple[List[Finding], dict]:
    """KERN002–KERN005 of one call (the card's memory and int64 rules
    where ``card``); returns the findings and what was observed. Only the
    call itself runs inside ``region()`` (a profiler label): the plain
    version and the comparisons, which copy and sync, run outside it.
    KERN001 and the card's copy rule need a profiler window:
    :func:`audit_calls`."""
    loc = call.loc
    operands = _tensors((call.args, call.kwargs))
    op_infos = [info(t) for t in operands]
    want_pool = call.plain_pool()
    pool = call.args[call.pool] if call.pool is not None else None
    pool_info = info(pool) if pool is not None else None
    dev = operands[0].device
    rec = OpRecorder()
    if card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        start = torch.cuda.memory_stats(dev)["requested_bytes.all.current"]
    with region():
        with rec:
            result = call.run()
        if card:
            torch.cuda.synchronize(dev)
    outs = _tensors(result)
    findings: List[Finding] = []
    seen = {"boundary_elems": sum(t.numel() for t in operands + outs)}
    if pool_info is not None:
        others = [t.numel for t in op_infos if t.storage != pool_info.storage]
        findings += pool_copy_findings(
            loc, rec.ops, pool_info, op_infos,
            floor=max(pool_info.numel, 1 + max(others, default=0)))
    if card:
        peak = torch.cuda.memory_stats(dev)["requested_bytes.all.peak"]
        known = {t.storage for t in op_infos}
        new_out = sum(t.nbytes for t in map(info, outs)
                      if t.storage not in known)
        seen["peak_scratch_bytes"] = peak - start - new_out
        if pool_info is not None and \
                seen["peak_scratch_bytes"] >= pool_info.nbytes:
            findings.append(Finding(
                loc, 0, "KERN002",
                f"{seen['peak_scratch_bytes']} bytes allocated at once beside "
                f"the outputs, not below the pool's {pool_info.nbytes}"))
        wide, seen["widest_int64"] = wide_int_findings(loc, rec.ops,
                                                       call.index_bound)
        findings += wide
    for i, t in enumerate(outs):
        if t.dtype != torch.int32:
            findings.append(Finding(loc, 0, "KERN003",
                                    f"output {i} is {t.dtype}, not int32"))
    if pool is not None and pool.dtype != torch.int32:
        findings.append(Finding(loc, 0, "KERN003",
                                f"the pool is {pool.dtype}, not int32"))
    if call.declared is not None and \
            seen["boundary_elems"] != call.declared:
        findings.append(Finding(
            loc, 0, "KERN004",
            f"boundary-transfer budget: declared {call.declared} elements, "
            f"observed {seen['boundary_elems']}"))
    if call.pool_out is not None:
        got = result[call.pool_out]
        if got.data_ptr() != pool.data_ptr():
            findings.append(Finding(
                loc, 0, "KERN005",
                "the returned pool is not the input's storage — the round "
                "is declared in place but is not"))
        if want_pool is not None and not (torch.equal(got, want_pool)
                                          and torch.equal(pool, want_pool)):
            findings.append(Finding(
                loc, 0, "KERN005",
                "the pool does not hold what the plain version writes"))
    return findings, seen


def audit_fn(fn: Callable, args: tuple, kwargs: Optional[dict] = None, *,
             name: str, pool: Optional[int] = None,
             pool_out: Optional[int] = None, plain: Optional[Callable] = None,
             declared: Optional[int] = None) -> List[Finding]:
    """KERN002–KERN005 of ``fn(*args, **kwargs)`` on the CPU — the
    primitive the registry and the fixture tests share."""
    return audit_call(Call(name, fn, tuple(args), dict(kwargs or {}),
                           declared=declared, pool=pool, pool_out=pool_out,
                           plain=plain))[0]


def _expected(call: Call, findings: List[Finding]) -> List[Finding]:
    """Drop the findings of the rules a negative control must raise, and
    report each such rule that did not fire."""
    out = [f for f in findings if f.rule not in call.expect]
    for rule in call.expect:
        if not any(f.rule == rule for f in findings):
            out.append(Finding(call.loc, 0, rule,
                               f"negative control broken: expected {rule}"))
    return out


# -- profiler windows ------------------------------------------------------------

def profile_window(body: Callable, *, device, warmup: Optional[Callable] = None):
    """Run ``body()`` under a ``torch.profiler`` window of CPU and CUDA
    activity; return ``(prof, body())``. A window can lose the device
    activity at its very start: it opens after a warm-up step (``warmup()``,
    traced and dropped), on a pause and a marker kernel launched through an
    aten op under :data:`WINDOW_MARKER_LABEL`, which the caller must find
    among the window's device events."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        if warmup is not None:
            warmup()
        torch.cuda.synchronize(device)
        prof.step()
        time.sleep(WINDOW_PAUSE_S)
        with record_function(WINDOW_MARKER_LABEL):
            torch.ones(1, device=device)         # a kernel under an aten op
        torch.cuda.synchronize(device)
        out = body()
        torch.cuda.synchronize(device)
        prof.step()
    return prof, out


def trace_events(prof) -> List[dict]:
    """The window's events as its Chrome trace writes them (the only
    place a ``Memcpy`` event's bytes are kept)."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_events_by_label(events: Sequence[dict], labels: Sequence[str]
                           ) -> Dict[str, List[dict]]:
    """The device events (kernels, copies, sets) launched under each
    label: a device event belongs to the label whose host range holds the
    runtime call that launched it (the two share a ``correlation`` id);
    where no runtime call carries its id, to the label whose range holds
    the event itself."""
    ranges: Dict[str, List[Tuple[float, float]]] = {
        lab: [] for lab in labels}
    launch_ts: Dict[int, float] = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat == "user_annotation" and e.get("name") in ranges:
            ts = float(e["ts"])
            ranges[e["name"]].append((ts, ts + float(e.get("dur", 0))))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = float(e["ts"])
    out: Dict[str, List[dict]] = {lab: [] for lab in labels}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        corr = (e.get("args") or {}).get("correlation")
        ts = launch_ts.get(corr, float(e["ts"]))
        for label, spans in ranges.items():
            if any(a <= ts <= b for a, b in spans):
                out[label].append(e)
                break
    return out


def copy_bytes(events: Sequence[dict], kind: str) -> int:
    """Bytes of the ``Memcpy <kind>`` events (``HtoD``, ``DtoH``)."""
    return sum(int((e.get("args") or {}).get("bytes", 0)) for e in events
               if e.get("cat") == "gpu_memcpy"
               and e.get("name", "").startswith(f"Memcpy {kind}"))


def kernel_names(events: Sequence[dict]) -> List[str]:
    return [e["name"] for e in events if e.get("cat") == "kernel"]


def _marker_finding(loc: str, by_label: Dict[str, List[dict]]
                    ) -> List[Finding]:
    if kernel_names(by_label[WINDOW_MARKER_LABEL]):
        return []
    return [Finding(loc, 0, "KERN001",
                    "the profiler window lost its marker kernel: its counts "
                    "cannot be trusted to hold the whole window")]


def _launch_counts() -> Dict[str, int]:
    out = dict(selective_copy.LAUNCHES)
    out.update(attention.LAUNCHES)
    out.update(mlstm_scan.LAUNCHES)
    return out


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


def audit_calls(calls: Sequence[Call], device) -> Tuple[List[Finding],
                                                        Dict[str, dict]]:
    """Audit each call; on a CUDA device every call runs once more as a
    warm-up (building the kernels), then all in one profiler window, each
    under its own label, for KERN001 and the copy rule of KERN004. Returns
    the findings and each call's observations."""
    dev = torch.device(device)
    seen: Dict[str, dict] = {}
    findings: List[Finding] = []
    if dev.type != "cuda":
        for c in calls:
            f, seen[c.name] = audit_call(c)
            seen[c.name]["rules"] = sorted({x.rule for x in f})
            findings += _expected(c, f)
        return findings, seen
    launched: Dict[str, dict] = {}

    def warmup():
        for c in calls:
            c.run()

    def body():
        out = []
        for c in calls:
            before = _launch_counts()
            out.append(audit_call(c, card=True, region=functools.partial(
                record_function, f"kernel_audit.{c.name}")))
            launched[c.name] = _delta(_launch_counts(), before)
        return out

    prof, results = profile_window(body, device=dev, warmup=warmup)
    labels = [f"kernel_audit.{c.name}" for c in calls]
    by_label = device_events_by_label(trace_events(prof),
                                      labels + [WINDOW_MARKER_LABEL])
    findings += _marker_finding("<kernels>", by_label)
    for c, label, (f, obs) in zip(calls, labels, results):
        evs = by_label[label]
        f = f + launch_findings(c.loc, kernel_names(evs),
                                {c.kernel: 1} if c.kernel else {},
                                launched[c.name])
        copies = [e["name"] for e in evs if e.get("cat") == "gpu_memcpy"
                  and e["name"].startswith(("Memcpy HtoD", "Memcpy DtoH"))]
        if copies:
            f.append(Finding(c.loc, 0, "KERN004",
                             f"{len(copies)} copies across the boundary "
                             f"inside a call on resident operands: {copies}"))
        obs.update(kernels=kernel_names(evs), copies=copies,
                   rules=sorted({x.rule for x in f}))
        findings += _expected(c, f)
        seen[c.name] = obs
    return findings, seen


def assert_fused(calls: Sequence[Call], device) -> None:
    """Raise AssertionError on any finding — the parity gate's entry."""
    findings, _ = audit_calls(calls, device)
    if findings:
        raise AssertionError("; ".join(f.format() for f in findings))


# -- the registry --------------------------------------------------------------

def op_call(name: str, op: Callable, impl: str, args: tuple, kwargs: dict,
            **kw) -> Call:
    """A call of the ``ops`` function ``op`` at ``impl`` (its kernel is
    the port kernel of ``op``'s name), its plain version at ``'ref'``."""
    return Call(name, functools.partial(op, impl=impl), args, kwargs,
                kernel=op.__name__, plain=functools.partial(op, impl="ref"),
                **kw)


def _case_dims(b=2, page=8, pps=4, meta_max=16):
    s = meta_max + pps * page
    p_total = b * pps + 2
    return s, p_total


def _selcopy(keystream: bool, clone_pool: bool = False):
    def build(name, device, impl) -> Call:
        rng = np.random.default_rng(7)
        b, page, pps, meta_max = 2, 8, 4, 16
        s, p_total = _case_dims(b, page, pps, meta_max)
        pool_rows = p_total + 1
        declared = (b * s + 2 * b + pool_rows * page + b * pps    # inputs
                    + b * meta_max + pool_rows * page)            # meta, pool
        kwargs = dict(meta_max=meta_max)
        if keystream:
            stream, ml, tl, pool, tables, ks = to_torch(selcopy_crypto_case(
                rng, b=b, page=page, pps=pps, meta_max=meta_max), device)
            kwargs["keystream"] = ks
            declared += b * s
        else:
            stream, ml, tl, pool, tables = to_torch(selcopy_case(
                rng, b=b, page=page, pps=pps, meta_max=meta_max), device)
        return op_call(name, ops.selective_copy, impl,
                      (stream, ml, tl, pool, tables), kwargs,
                      declared=declared, pool=3, pool_out=1,
                      index_bound=b * pps, clone_pool=clone_pool,
                      expect=("KERN002", "KERN005") if clone_pool else ())
    return build


def _selgather(keystream: bool):
    def build(name, device, impl) -> Call:
        rng = np.random.default_rng(8)
        b, page, pps = 2, 8, 4
        p_total = b * pps + 2
        pool, tables, lengths, ks = to_torch(
            selgather_case(rng, b=b, page=page, pps=pps), device)
        declared = ((p_total + 1) * page + b * pps + b
                    + (b * pps * page if keystream else 0)   # keystream
                    + b * pps * page)                        # gathered out
        return op_call(name, ops.selective_gather, impl,
                      (pool, tables, lengths),
                      dict(keystream=ks if keystream else None),
                      declared=declared, pool=0, index_bound=b * pps)
    return build


def _policy(keystream: bool, live: bool):
    def build(name, device, impl) -> Call:
        rng = np.random.default_rng(9)
        b, meta_max, r, k = 4, 16, 6, 3
        case = policy_case(rng, b=b, meta_max=meta_max, r=r, k=k)
        lv = policy_live_column(rng, r) if live else None
        meta, ml, off, lo, hi, ks = to_torch(case, device)
        declared = (b * meta_max + b + 3 * r * k
                    + (b * meta_max if keystream else 0)
                    + (r if live else 0)
                    + b)  # verdict out
        return op_call(name, ops.policy_match, impl, (meta, ml, off, lo, hi),
                      dict(keystream=ks if keystream else None,
                           live=to_torch(lv, device)), declared=declared)
    return build


def _policy_payload(keystream: bool, live: bool):
    def build(name, device, impl) -> Call:
        rng = np.random.default_rng(10)
        b, meta_max, r, k, w = 4, 16, 6, 3, 8
        case = policy_payload_case(rng, b=b, meta_max=meta_max, r=r, k=k,
                                   w=w)
        lv = policy_live_column(rng, r) if live else None
        meta, ml, off, lo, hi, ks, pay, plen = to_torch(case, device)
        declared = (b * meta_max + b + 3 * r * k
                    + (b * meta_max if keystream else 0)
                    + (r if live else 0)
                    + b * w + b       # payload window + payload_len
                    + b)              # verdict out
        return op_call(name, ops.policy_match, impl, (meta, ml, off, lo, hi),
                      dict(keystream=ks if keystream else None,
                           live=to_torch(lv, device), payload=pay,
                           payload_len=plen), declared=declared)
    return build


def _fused(crypto: bool, policy: bool, n_buffers: int = 0):
    """The one-launch scheduling round: KERN001 == 1 here IS the 3-to-1
    launch collapse (anchor + crypt + match + gather in one launch)."""
    def build(name, device, impl) -> Call:
        rng = np.random.default_rng(12)
        b, page, pps, meta_max, r, k = 2, 8, 4, 16, 6, 3
        s, p_total = _case_dims(b, page, pps, meta_max)
        case = to_torch(fused_round_case(rng, b=b, page=page, pps=pps,
                                         meta_max=meta_max, r=r, k=k), device)
        kw = dict(meta_max=meta_max, n_buffers=n_buffers)
        if crypto:
            kw.update(keystream=case["keystream"],
                      tx_keystream=case["tx_keystream"])
        if policy:
            kw.update(cond_off=case["cond_off"], cond_lo=case["cond_lo"],
                      cond_hi=case["cond_hi"], live=case["live"])
            if crypto:
                kw.update(meta_ks=case["meta_ks"])
        pool_rows = p_total + 1
        declared = (b * s + 2 * b + pool_rows * page + b * pps     # inputs
                    + (b * s + b * pps * page if crypto else 0)    # rx+tx ks
                    + (3 * r * k + r if policy else 0)             # conds+live
                    + (b * meta_max if crypto and policy else 0)   # meta ks
                    + b * meta_max + pool_rows * page              # meta, pool
                    + b * pps * page                               # gather out
                    + (b if policy else 0))                        # verdict
        args = (case["stream"], case["meta_len"], case["total_len"],
                case["pool"], case["tables"])
        return op_call(name, ops.fused_round, impl, args, kw,
                      declared=declared, pool=3, pool_out=1,
                      index_bound=b * pps)
    return build


#: name -> ``build(name, device, impl) -> Call``: the JAX registry's
#: entries under the same names, but ``selective_copy[legacy]`` (the port
#: has no ``reserved_scratch`` mode); its role as the negative control goes
#: to ``selective_copy[cloned-pool]``
KERNEL_ENTRIES: Dict[str, Callable[..., Call]] = {
    "selective_copy[reserved]": _selcopy(False),
    "selective_copy[keystream]": _selcopy(True),
    "selective_copy[cloned-pool]": _selcopy(False, clone_pool=True),
    "selective_gather": _selgather(False),
    "selective_gather[keystream]": _selgather(True),
    "policy_match": _policy(False, False),
    "policy_match[keystream]": _policy(True, False),
    "policy_match[live]": _policy(False, True),
    "policy_match[keystream+live]": _policy(True, True),
    "policy_match[payload]": _policy_payload(False, False),
    "policy_match[payload+keystream+live]": _policy_payload(True, True),
    "fused_round": _fused(False, False),
    "fused_round[policy]": _fused(False, True),
    "fused_round[crypto]": _fused(True, False),
    "fused_round[crypto+policy]": _fused(True, True),
    "fused_round[crypto+policy+dma2]": _fused(True, True, n_buffers=2),
}


def registry_calls(device) -> List[Call]:
    """Every registry entry as a call on ``device``: the CUDA kernels on a
    CUDA device, the plain versions on the CPU."""
    impl = "cuda" if torch.device(device).type == "cuda" else "ref"
    return [build(name, device, impl)
            for name, build in KERNEL_ENTRIES.items()]


@dataclasses.dataclass
class KernelReport(Report):
    """A :class:`Report` that also names the rules it could not run."""
    not_run: List[str] = dataclasses.field(default_factory=list)

    def lines(self) -> List[str]:
        return super().lines() + ["  " + n for n in self.not_run]


def run(device=None) -> KernelReport:
    """Audit every registry entry on ``device`` (default: the CUDA device;
    with none present this raises, it never runs the CPU's rules
    instead). On the CPU, KERN001 is reported as not run."""
    dev = ops.checked_device("cuda" if device is None else device)
    findings, _seen = audit_calls(registry_calls(dev), dev)
    not_run = [] if dev.type == "cuda" else [
        "KERN001 not run: kernel launches are counted on a CUDA device "
        "only (the CPU runs the plain versions)"]
    return KernelReport(name=f"kernels[{dev.type}]", active=findings,
                        waived=[], not_run=not_run)


# -- whole runs on the card -----------------------------------------------------

def _by_site(ops: Sequence[OpCall], src: str, dst: str) -> Dict[tuple, int]:
    """Bytes of the copies from device type ``src`` to ``dst``, by the
    site (file, line, function) that made them."""
    out: Dict[tuple, int] = {}
    for op in ops:
        if op.site is None or not op.ins or not op.outs:
            continue
        if op.ins[0].device == src and op.outs[0].device == dst:
            out[op.site] = out.get(op.site, 0) + op.outs[0].nbytes
    return out


def uncounted_crossings(ops: Sequence[OpCall]
                        ) -> Tuple[List[Finding], int, int]:
    """KERN004 findings for the copies across the boundary that the pool's
    ``xfer`` counters do not count (sites outside :data:`COUNTED_H2D`,
    :data:`INDEX_H2D` and :data:`COUNTED_D2H`), one per line, and their
    bytes host to device and device to host."""
    findings, totals = [], []
    for src, dst, counted, way in (
            ("cpu", "cuda", COUNTED_H2D | {INDEX_H2D}, "host to device"),
            ("cuda", "cpu", COUNTED_D2H, "device to host")):
        total = 0
        for (file, line, func), nbytes in sorted(_by_site(ops, src,
                                                          dst).items()):
            if (file, func) in counted:
                continue
            total += nbytes
            findings.append(Finding(
                file, line, "KERN004",
                f"{func}() moves {nbytes} bytes {way} that the pool's xfer "
                f"counters do not count"))
        totals.append(total)
    return findings, totals[0], totals[1]


def waive(findings: Sequence[Finding]) -> Tuple[List[Finding],
                                                List[Finding]]:
    """(active, waived): waiver comments at the flagged lines of the
    repo's files apply. A run reaches only some lines, so an unused
    waiver is not reported stale here."""
    files = {f.file for f in findings if (REPO_ROOT / f.file).is_file()}
    waivers = {f: scan_waivers((REPO_ROOT / f).read_text()) for f in files}
    return apply_waivers(list(findings), waivers, rules=())


def audit_rounds(runtime) -> dict:
    """Run ``runtime.run()`` (a ``ProxyRuntime`` whose stack's pool is
    resident on a CUDA device) under a profiler window and a dispatch
    record, and hold it to the kernel rules and the pool's counters:

    - KERN001: each port kernel's profiler events equal its wrapper's
      launches, and ``fused_round`` = Δ``fused_rounds``, ``selective_copy``
      = Δ``anchor_rounds`` − Δ``fused_rounds``, ``policy_match`` =
      Δ``policy_match_rounds``, ``selective_gather`` = Δ``device_rounds``
      − Δ``anchor_rounds`` (a fused round's missed TX speculation gathers
      in its own launch); no other kernel of the port;
    - KERN004: the ``Memcpy HtoD`` bytes equal 4 x Δ``h2d_tokens`` (int32)
      plus 8 bytes a row of the int64 row ids ``DevicePool._index``
      uploads (no counter holds them: the audit wraps ``_index`` on the
      instance), and ``DtoH`` bytes 4 x Δ``d2h_tokens``; a crossing that
      no counter counts is a finding at its line (waivable there), and its
      bytes are reckoned in;
    - KERN002: no pool copy, no new tensor of the pool's elements, and a
      peak allocation over the run below the pool's bytes;
    - KERN005: the pool's storage is the same after the run;
    - KERN003: no int64 device tensor wider than the widest round's table
      (rows x pages a row).

    Returns the numbers, and the findings (``active``, ``waived``)."""
    pool = runtime.stack.pool
    if not isinstance(pool, DevicePool) or pool._dev is None \
            or pool._dev.device.type != "cuda":
        raise RuntimeError("audit_rounds needs a stack whose DevicePool is "
                           "resident on a CUDA device")
    dev = pool._dev.device
    x0, l0 = dict(pool.xfer), _launch_counts()
    index_rows, widest_table = [0], [0]
    index, setup = pool._index, pool._round_setup

    def counted_index(rows):
        index_rows[0] += len(rows)
        return index(rows)

    def sized_setup(tables, *ops):
        widest_table[0] = max(widest_table[0], int(tables.size))
        return setup(tables, *ops)

    pool._index, pool._round_setup = counted_index, sized_setup
    ptr0, pool_info = pool._dev.data_ptr(), info(pool._dev)
    rec = OpRecorder()

    def body():
        with record_function(ROUNDS_LABEL), rec:
            msgs = runtime.run()
            torch.cuda.synchronize(dev)
        return msgs

    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    mem0 = torch.cuda.memory_allocated(dev)
    rounds0, t0 = runtime.rounds, time.perf_counter()
    try:
        prof, msgs = profile_window(body, device=dev)
    finally:
        del pool._index, pool._round_setup     # the class's methods again
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - mem0
    by_label = device_events_by_label(trace_events(prof),
                                      [ROUNDS_LABEL, WINDOW_MARKER_LABEL])
    evs = by_label[ROUNDS_LABEL]
    dx = _delta(pool.xfer, x0)
    launched = _delta(_launch_counts(), l0)
    loc = f"<rounds:{runtime.batch_impl}>"
    findings = _marker_finding(loc, by_label)
    expected = {
        "fused_round": dx["fused_rounds"],
        "selective_copy": dx["anchor_rounds"] - dx["fused_rounds"],
        "policy_match": dx["policy_match_rounds"],
        "selective_gather": dx["device_rounds"] - dx["anchor_rounds"],
    }
    findings += launch_findings(loc, kernel_names(evs), expected, launched)
    by_kernel = dict.fromkeys(PORT_KERNELS, 0)
    for n in kernel_names(evs):
        if port_kernel(n):
            by_kernel[port_kernel(n)] += 1
    # boundary bytes
    sites, up_other, down_other = uncounted_crossings(rec.ops)
    h2d, d2h = copy_bytes(evs, "HtoD"), copy_bytes(evs, "DtoH")
    h2d_want = 4 * dx["h2d_tokens"] + 8 * index_rows[0] + up_other
    d2h_want = 4 * dx["d2h_tokens"] + down_other
    for kind, got, want in (("HtoD", h2d, h2d_want), ("DtoH", d2h, d2h_want)):
        if got != want:
            findings.append(Finding(
                loc, 0, "KERN004",
                f"Memcpy {kind}: the profiler saw {got} bytes, the counters "
                f"and the reckoned crossings say {want}"))
    # pool copies, memory, storage, int64
    findings += pool_copy_findings(loc, rec.ops, pool_info, [pool_info],
                                   floor=pool_info.numel)
    if peak >= pool_info.nbytes:
        findings.append(Finding(
            loc, 0, "KERN002",
            f"peak allocation over the run {peak} bytes, not below the "
            f"pool's {pool_info.nbytes}"))
    stable = pool._dev.data_ptr() == ptr0
    if not stable:
        findings.append(Finding(loc, 0, "KERN005",
                                "the pool's storage moved during the run"))
    wide, widest = wide_int_findings(loc, rec.ops, widest_table[0])
    findings += wide
    active, waived = waive(findings + sites)
    return {
        "impl": runtime.batch_impl, "rounds": runtime.rounds - rounds0,
        "msgs": msgs, "wall_s": wall,
        "xfer_delta": {k: dx[k] for k in (
            "h2d_tokens", "d2h_tokens", "device_rounds", "anchor_rounds",
            "fused_rounds", "policy_match_rounds", "pool_syncs")},
        "kernel_events": by_kernel, "launches": {
            k: v for k, v in launched.items() if k in PORT_KERNELS},
        "h2d_bytes": h2d, "h2d_counted_bytes": 4 * dx["h2d_tokens"],
        "h2d_index_bytes": 8 * index_rows[0], "h2d_uncounted_bytes": up_other,
        "d2h_bytes": d2h, "d2h_counted_bytes": 4 * dx["d2h_tokens"],
        "d2h_uncounted_bytes": down_other,
        "peak_alloc_bytes": peak, "pool_bytes": pool_info.nbytes,
        "storage_stable": stable, "widest_int64": widest,
        "int64_bound": widest_table[0],
        "active": [f.format() for f in active],
        "waived": [f.format() for f in waived],
    }
