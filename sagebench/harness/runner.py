"""One run of one cell against the program: set-up, the measured window,
then the check of what the window served.

The program is ``repro_torch``'s SAGE runtime: one node
(``SageRuntime("sage")``, ``time_scale`` 0, so no modelled sleep enters a
number) over a host ``Database`` that holds the weights, and the mix's
functions (one unless it says more), each from
``repro_torch.core.functions._model_function`` at the configuration's
widths with weights of its own. Each invocation is ``SageRuntime.submit``
of a request to one function whose tokens are one of the run's prompts;
the function returns the last position's first eight logits of each row.

The harness makes the weights and the prompts from the seed and hands each
function's weights to ``_model_function`` in place of the ones it would
draw (``_host_params``); the reference draws the same ones again once the
program's state is gone. Around the function's handler the harness keeps
its own span (``handler``): when the handler began, after the runtime's
compute lock, and when it returned. It also keeps the program's own spans
of each invocation and its counters' changes over the window
(``harness/spans.py``)."""
from __future__ import annotations

import dataclasses
import gc
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

import torch

from harness import counts, spans as program_spans, trace as tracing, traffic, weights

FOREIGN = ("jax", "jaxlib", "flax", "repro")
LATE_S = 60.0  # how long past the window's close an answer is waited for
FUNCTION = "model"
# the share of the card's memory the node's memory daemon may fill with the
# functions' data; the rest holds the forward's activations and the contexts
CARD_SHARE = 0.9


@dataclasses.dataclass
class Invocation:
    index: int
    prompt: int
    due: float
    function: int = 0
    sent: float = 0.0
    done: Optional[float] = None
    uuid: str = ""
    out_key: Optional[str] = None
    error: Optional[str] = None
    answer: object = None
    node: Optional[dict] = None  # a fresh node's start and stop, where it had one


def foreign_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN)


class Program:
    """The system under test, built over one host database: one function
    for each weight tree of ``host_weights``."""

    def __init__(self, model: dict, host_weights: List[dict], batch: int, seq: int, device,
                 capacity_bytes: Optional[int] = None, compute: Optional[dict] = None):
        from repro_torch.configs.base import ModelConfig
        from repro_torch.core import functions
        from repro_torch.data.database import Database

        self.device = torch.device(device)
        self.cfg = ModelConfig(**model)
        self.db = Database(device=self.device)
        self.capacity_bytes = capacity_bytes
        self.compute = compute
        self.spans: Dict[str, tuple] = {}
        self.program_spans: Dict[str, list] = {}
        self.fns = []
        drawn = functions._host_params
        try:
            for f, tree in enumerate(host_weights):
                functions._host_params = lambda cfg, seed, dev, tree=tree: tree
                fn = functions._model_function(self.db, f"{FUNCTION}{f}", self.cfg,
                                               batch=batch, seq=seq)
                self.fns.append(dataclasses.replace(fn, handler=self._spanned(fn.handler)))
        finally:
            functions._host_params = drawn
        self.records: Dict[str, object] = {}

    def _spanned(self, inner):
        spans = self.spans

        def handler(shim, request):
            t = time.monotonic()
            try:
                return inner(shim, request)
            finally:
                spans[request.uuid] = (t, time.monotonic())
        return handler

    def node(self):
        from repro_torch.core.runtime import SageRuntime

        sized = {} if self.capacity_bytes is None else {"device_capacity": self.capacity_bytes}
        if self.compute is not None:
            sized["compute"] = self.compute
        rt = SageRuntime("sage", database=self.db, time_scale=0.0, exit_ttl=3600.0,
                         load_timeout_s=300.0, device=str(self.device), **sized)
        rt.sage_init()
        for fn in self.fns:
            rt.register_function(fn)
        return rt

    def request(self, function: int, tokens: torch.Tensor):
        from repro_torch.core.request import Data, DataType, Request

        fn = self.fns[function]
        req = Request(function_name=fn.name)
        key = f"{fn.name}/in/{req.uuid}"
        size = tokens.numel() * tokens.element_size()
        self.db.put(key, tokens, size=size)
        ro = next(iter(fn.read_only))
        req.in_data = [Data(key=ro, size=fn.read_only[ro], dtype=DataType.READ_ONLY),
                       Data(key=key, size=size, dtype=DataType.WRITABLE)]
        return req

    def keep_records(self, rt) -> None:
        """The node's records and, where the program records them, each
        invocation's spans: kept before a fresh node is retired."""
        spans_of = getattr(rt.telemetry, "spans_of", None)
        for rec in rt.telemetry.snapshot():
            self.records[rec.request_id] = rec
            if spans_of is not None:
                self.program_spans[rec.request_id] = spans_of(rec.request_id)

    def counters(self) -> dict:
        """The program's counters now (``spans.py``): the database's copied
        bytes and seconds, and the forwards by kind summed over the
        functions; a counter the program lacks is left out."""
        from repro_torch.core import functions

        out = {k: getattr(self.db, k) for k in ("h2d_bytes", "h2d_s") if hasattr(self.db, k)}
        for k in program_spans.FORWARDS:
            by_function = getattr(functions, k, None)
            if by_function is not None:
                out[k] = sum(by_function.values())
        return out


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _serve_one(prog: Program, rt, function: int, tokens) -> Invocation:
    """One invocation outside the window (set-up), waited for."""
    inv = Invocation(index=-1, prompt=0, due=time.monotonic(), function=function)
    req = prog.request(function, tokens)
    inv.uuid, inv.sent = req.uuid, time.monotonic()
    inv.out_key = rt.submit(req).result(timeout=600)
    inv.done = time.monotonic()
    return inv


def retire(prog: Program, rt) -> None:
    """Drain a node (wait for its work, then its teardown), stop it, and
    keep its records."""
    try:
        rt.drain(timeout=LATE_S)
    except TimeoutError:  # still busy: its invocations count as failed
        pass
    rt.shutdown()
    prog.keep_records(rt)


def _finish(inv: Invocation, fut) -> None:
    inv.done = time.monotonic()
    try:
        inv.out_key = fut.result()
    except Exception as exc:  # the invocation failed: it counts in ``failed``
        inv.error = f"{type(exc).__name__}: {exc}"


def run_open(prog, rt, host_prompts, order, fn_order, due, t0) -> List[Invocation]:
    invs = []
    for i, d in enumerate(due):
        wait = t0 + d - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        p, f = order[i % len(order)], fn_order[i % len(fn_order)]
        inv = Invocation(index=i, prompt=p, due=t0 + d, function=f)
        req = prog.request(f, host_prompts[p])
        inv.uuid, inv.sent = req.uuid, time.monotonic()
        fut = rt.submit(req)
        fut.add_done_callback(lambda f, inv=inv: _finish(inv, f))
        invs.append(inv)
    return invs


def run_closed(prog, rt, host_prompts, order, fn_order, clients, fresh, t0,
               t_end) -> List[Invocation]:
    invs: List[Invocation] = []
    lock = threading.Lock()

    def client(k: int) -> None:
        j = 0
        while time.monotonic() < t_end:
            i = k + clients * j
            j += 1
            p, f = order[i % len(order)], fn_order[i % len(fn_order)]
            node, started = rt, None
            if fresh:
                started = time.monotonic()
                node = prog.node()
            inv = Invocation(index=i, prompt=p, due=time.monotonic(), function=f)
            req = prog.request(f, host_prompts[p])
            inv.uuid, inv.sent = req.uuid, time.monotonic()
            with lock:
                invs.append(inv)
            fut = node.submit(req)
            try:
                fut.result(timeout=t_end - time.monotonic() + LATE_S)
            except Exception:  # recorded by _finish below; a timeout leaves done None
                pass
            if fut.done():
                _finish(inv, fut)
            if fresh:
                stop = time.monotonic()
                retire(prog, node)
                inv.node = {"start_s": inv.sent - started, "stop_s": time.monotonic() - stop}

    threads = [threading.Thread(target=client, args=(k,), name=f"client{k}")
               for k in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(t_end - time.monotonic() + 2 * LATE_S)
    return sorted(invs, key=lambda v: v.index)


def setup(config: dict, mix: dict, seed: int, device, reference, log) -> tuple:
    """Weights and prompts from the seed, the program over them, one node
    with the set-up's cold invocations (one for each function) and the
    mix's warm-ups served. For a mix whose every invocation goes to a new
    node, that node goes too, and a second cycle (start, cold invocation,
    stop) warms the window's cycle; the node returned is then None.
    Returns (program, node, host prompts, prompt order, function order)."""
    m = config["model"]
    cuda = torch.device(device).type == "cuda"
    marks = [("start", time.monotonic())]
    host, drawn_s, locked_s = [], 0.0, 0.0
    for f in range(int(mix.get("functions", 1))):
        t = time.monotonic()
        tree = weights.make(reference.layout(m), seed, device, function=f)
        _sync(device)
        drawn_s += time.monotonic() - t
        t = time.monotonic()
        if cuda:
            from repro_torch.data.database import page_locked
            host.append(page_locked(tree))
        else:
            host.append(tree)
        del tree
        locked_s += time.monotonic() - t
    marks.append(("weights", time.monotonic()))
    prompts_dev = traffic.prompts(mix, m["vocab_size"], seed, device)
    host_prompts = prompts_dev.cpu()
    if cuda:
        host_prompts = host_prompts.pin_memory()
    del prompts_dev
    order = traffic.prompt_order(int(mix["prompts"]), seed)
    fn_order = traffic.function_order(mix)
    prog = Program(m, host, int(mix["batch"]), int(mix["seq"]), device,
                   int(CARD_SHARE * torch.cuda.get_device_properties(device).total_memory)
                   if cuda else None, mix.get("compute"))
    del host
    marks.append(("program", time.monotonic()))
    served = []
    rt = prog.node()
    served.append(_serve_one(prog, rt, 0, host_prompts[order[0]]))
    marks.append(("first_cold", time.monotonic()))
    for f in range(1, len(prog.fns)):
        served.append(_serve_one(prog, rt, f, host_prompts[order[f % len(order)]]))
    marks.append(("other_colds", time.monotonic()))
    for k in range(int(mix.get("warm_invocations", 0))):
        served.append(_serve_one(prog, rt, fn_order[k % len(fn_order)],
                                 host_prompts[order[(k + 1) % len(order)]]))
    if mix.get("fresh_node"):
        retire(prog, rt)
        rt = prog.node()
        served.append(_serve_one(prog, rt, 0, host_prompts[order[1 % len(order)]]))
        retire(prog, rt)
        rt = None
    else:
        prog.keep_records(rt)
    marks.append(("warm_ups", time.monotonic()))
    parts = {b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}
    parts.update(weights_drawn=drawn_s, page_locked=locked_s)
    log({"setup_s_by_part": parts,
         "setup_invocations": [_record_line(prog, inv) for inv in served]})
    return prog, rt, host_prompts, order, fn_order


def run_cell(config: dict, mix: dict, *, seed: int, seconds: float, trace: bool,
             device: str, log: Callable[[dict], None], reference,
             t_process: Optional[float] = None) -> dict:
    """One run. ``config`` is a configuration's file, ``mix`` a traffic
    mix's, ``reference`` the configuration's reference module. Returns
    what the metrics read (``context``) and the window's invocations."""
    t_process = time.monotonic() if t_process is None else t_process
    m = config["model"]
    batch, seq = int(mix["batch"]), int(mix["seq"])
    cuda = torch.device(device).type == "cuda"
    fresh = bool(mix.get("fresh_node"))
    prog, rt, host_prompts, order, fn_order = setup(config, mix, seed, device, reference, log)
    stats0 = dict(rt.daemon.stats) if rt is not None else {}
    _sync(device)
    counters0 = prog.counters()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    prof = tracing.start() if trace else None

    # --- the window
    t0 = time.monotonic()
    setup_s = t0 - t_process
    t_end = t0 + seconds
    with torch.profiler.record_function(tracing.WINDOW):
        if mix["loop"] == "open":
            due = traffic.open_schedule(float(mix["rate_per_s"]), seconds,
                                        int(mix["schedule_seed"]), mix.get("burst"))
            invs = run_open(prog, rt, host_prompts, order, fn_order, due, t0)
            deadline = t_end + LATE_S
            while any(v.done is None for v in invs) and time.monotonic() < deadline:
                time.sleep(0.001)
        else:
            invs = run_closed(prog, rt, host_prompts, order, fn_order, int(mix["clients"]),
                              fresh, t0, t_end)
        _sync(device)
        counters1 = prog.counters()
    summary = None
    if prof is not None:
        prof.stop()
        summary = tracing.summarize(prof)
        del prof
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    stats1 = dict(rt.daemon.stats) if rt is not None else {}
    if rt is not None:
        prog.keep_records(rt)
    for inv in invs:
        if inv.out_key is not None:
            inv.answer = prog.db.fetch(inv.out_key)
    records = {inv.uuid: prog.records.get(inv.uuid) for inv in invs}
    own = {inv.uuid: prog.program_spans.get(inv.uuid) for inv in invs}
    spans = dict(prog.spans)
    if rt is not None:
        retire(prog, rt)
    context = {
        "invocations": [_record(inv, records.get(inv.uuid), spans.get(inv.uuid), t0,
                                own.get(inv.uuid)) for inv in invs],
        "seconds": seconds, "setup_s": setup_s,
        "stats": {k: stats1.get(k, 0) - stats0.get(k, 0) for k in stats1},
        "counters": {k: v - counters0[k] for k, v in counters1.items() if k in counters0},
        "trace": summary, "model": m, "mix": mix, "batch": batch, "seq": seq,
        "flops_per_invocation": counts.model_flops(m, batch, seq)["total"],
        "memory_peak_bytes": peak,
    }
    del rt, prog, records, spans, own
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return {"context": context, "invocations": invs}


def _record(inv: Invocation, rec, span, t0: float, own: Optional[list] = None) -> dict:
    """One invocation of the window as the metrics read it: times in
    seconds from the window's start; ``own`` is the program's spans of it."""
    out = {"index": inv.index, "prompt": inv.prompt, "function": inv.function,
           "due": inv.due - t0,
           "sent": inv.sent - t0, "done": None if inv.done is None else inv.done - t0,
           "failed": inv.error is not None or inv.done is None, "error": inv.error,
           "node": inv.node}
    if rec is not None:
        out.update({"arrival": rec.arrival_t - t0, "start": rec.start_t - t0,
                    "end": rec.end_t - t0, "warm_stage": rec.warm_stage,
                    "stages": dict(rec.stages), "setup_wall": rec.setup_wall})
        if own is not None:
            out["spans"] = [(n, a - t0, b - t0) for n, a, b in own]
    if span is not None:
        out["handler"] = (span[0] - t0, span[1] - t0)
    return out


def _record_line(prog: Program, inv: Invocation) -> dict:
    rec = prog.records.get(inv.uuid)
    line = {"function": inv.function, "e2e_ms": (inv.done - inv.sent) * 1e3}
    if rec is not None:
        line.update({"warm_stage": rec.warm_stage, "setup_wall_ms": rec.setup_wall * 1e3,
                     "stages_ms": {k: v * 1e3 for k, v in rec.stages.items()}})
    return line
