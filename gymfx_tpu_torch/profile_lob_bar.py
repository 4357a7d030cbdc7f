"""Where K8's time goes, on the card, at the LOB venue's shape.

    python -m gymfx_tpu_torch.profile_lob_bar

K8 (``ops/lob_bar.run_bar``, ``csrc/lob_kernels.cu`` ``lob_bar_kernel``)
on flagship-lob-train's bar: 8,192 books of 24 x 4 seeded at the open,
64 ``lob_volatile`` flow messages each and the agent orders of
``ops/cases.lob_bar_case`` (every path of ``cases.LOB_BAR_PATHS``).  The
flow is also drawn with one message kind alone (``bar_messages`` under
the scenario's FlowParams with the kind's probability set to 1), and the
market orders with one side alone, so that a message's cost splits by
kind and side: each row is the kernel's device time per call from CUDA
graph replays (CUDA events, median of 11 replays of 20 calls) and per
message (over the 64 flow messages).

The venue's mix is also timed at fewer books (``--books``): 528 (one
warp a scheduler) and 3,168 (one full wave at 24 warps an SM), so that
the time of a wave shows whether a book's chain of dependent steps
(latency) or the instructions the SM issues for all its books
(throughput) hold the kernel.  Beside the times it prints ptxas' report
of K8 at the venue's template.  To compare with another tree, run this
module from each tree in one call, in turns.

It prints one JSON line and writes it to
``chiprun_out/profile_lob_bar.json``.  It needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess

import torch

from gymfx_tpu_torch.lob.book import MSG_MARKET, BookState, Messages
from gymfx_tpu_torch.lob.flow import bar_key, bar_messages
from gymfx_tpu_torch.lob.scenarios import scenario_flow_params
from gymfx_tpu_torch.ops import _build, cases, lob_bar
from gymfx_tpu_torch.profile_attention import graph_ms

ROOT = pathlib.Path(__file__).resolve().parent.parent
N_BOOKS, DEPTH, SLOTS, N_MSGS, SCENARIO = 8192, 24, 4, 64, "lob_volatile"
# ptxas: the kernel of the venue's template and the lines after it
_VENUE_TEMPLATE = "lob_bar_kernelILi1ELi4E"


def venue_ptxas(compiler_out: str) -> list:
    """ptxas' lines about K8 at the venue's template."""
    lines, on = [], False
    for line in compiler_out.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            on = _VENUE_TEMPLATE in line
        if on:
            lines.append(line.strip())
    return lines


def flows(dev):
    """{label: (B, M) flow}: the venue's mix, each kind alone, and the
    market orders of one side."""
    case = cases.lob_bar_case(N_BOOKS, depth=DEPTH, slots=SLOTS, n_msgs=N_MSGS, seed=0,
                              scenario=SCENARIO, device=dev)
    book, mix, orders, _ = case
    fp = scenario_flow_params(SCENARIO)
    # each book's bar around the open tick it was seeded at
    gen = torch.Generator().manual_seed(1)
    o = orders.open_tick.cpu()
    c = o + torch.randint(-20, 21, (N_BOOKS,), dtype=torch.int32, generator=gen)
    h = torch.maximum(o, c) + torch.randint(0, 15, (N_BOOKS,), dtype=torch.int32, generator=gen)
    lo = torch.minimum(o, c) - torch.randint(0, 15, (N_BOOKS,), dtype=torch.int32, generator=gen)
    rows = torch.arange(N_BOOKS, dtype=torch.int32)
    out = {"mix": mix}
    for kind, over in cases.FLOW_ONE_KIND.items():
        msgs = bar_messages(bar_key(0, rows), o, h, lo, c, N_MSGS, fp._replace(**over))
        out[kind] = Messages(*(x.to(dev).contiguous() for x in msgs))
    market = out["market"]
    for side, label in ((1, "market_buy"), (-1, "market_sell")):
        out[label] = market._replace(side=torch.full_like(market.side, side))
    assert all(bool((x.kind == MSG_MARKET).all()) for k, x in out.items() if k.startswith("market"))
    return book, orders, out


def time_flows(book, orders, streams, books=()) -> dict:
    """{label: us a call and a message} of K8 (``lob_bar.run_bar``) on
    each flow, and on the venue's mix at the first ``b`` books for b in
    ``books`` ("mix@b")."""
    cases_ = [(label, flow, N_BOOKS) for label, flow in streams.items()]
    cases_ += [(f"mix@{b}", streams["mix"], b) for b in books]
    rows = {}
    for label, flow, b in cases_:
        bk, fl, od = (type(x)(*(t[:b].contiguous() for t in x)) for x in (book, flow, orders))
        ours, ref = lob_bar.run_bar(bk, fl, od), lob_bar.run_bar_plain(bk, fl, od)
        for x, y in zip((*ours[0], *ours[1]), (*ref[0], *ref[1])):
            if not torch.equal(x, y):
                raise RuntimeError(f"profile_lob_bar: K8 != plain on {label}")
        ms = graph_ms(lambda: lob_bar.run_bar(bk, fl, od))
        rows[label] = {"us": ms * 1e3, "us_per_msg": ms * 1e3 / N_MSGS}
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--books", type=int, nargs="*", default=[528, 3168])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_lob_bar needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    dev = torch.device("cuda")
    book, orders, streams = flows(dev)
    _, compiler_out = _build.build_library("lob", ptxas_verbose=True)
    row = {"device": smi, "ptxas": venue_ptxas(compiler_out),
           **time_flows(book, orders, streams, args.books)}
    print(json.dumps(row))
    outdir = ROOT / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    (outdir / "profile_lob_bar.json").write_text(json.dumps(row, indent=1))


if __name__ == "__main__":
    main()
