"""Hold the port's schedules of llama3-8b's published config above seq
2048, and of the mixture-of-experts configs' published train steps,
against the reference's planning, node for node, on the CPU.

The published config (32 layers, bf16) traces about 10^5 aten ops at
these lengths, minutes each here, too long for the test suite; the smoke
and 2-layer cuts of the same steps are held in
``tests/test_torch_long_schedules.py``, with the same comparison. Rows:

* ``train_4096``: ``map_arch("llama3-8b", "train")``, batch 1, seq 4096;
* ``prefill_8192`` / ``prefill_32768``: ``make_prefill_step``, batch 1
  (the reference's ``map_arch`` has no prefill kind: its ``build_graph``
  on the step);
* ``prefill_32768_1_layer``: the same cut to 1 layer. At 32 layers the
  port's capture at seq 32768 is ~6 M aten ops (66,560 pair iterations),
  hours on a CPU core here at ~1 ms an op and tens of GB: this row holds
  the pair scan at that length (2,080 pairs, 183,000 aten ops), and
  ``prefill_8192`` the 32-layer stack around it;
* ``granite_train_128``: ``map_arch("granite-moe-1b-a400m", "train")``
  as published (24 layers, bf16, remat), seq 128 (~20 s);
* ``maverick_train_128_1_unit``: llama4-maverick-400b-a17b at its
  published width, one unit (2 layers), float32, ``grad_accum`` 1, seq
  128 (~5 s; the smoke cuts of both are held in
  ``tests/test_torch_moe_train_schedules*.py``).

For each it prints one JSON line: the nodes, subarrays and nodes by
``repeat`` of both, whether every node's row (kind, shape, MACs, edges,
``repeat``, name), the placement, the report and ``reconcile()`` are
equal, and the seconds each side took. The reference's traced train step
holds equations with no outputs, which its graph builder cannot read
under jax 0.9; they are dropped recursively, as the tests do.

Run from the repository root (the reference package is the JAX one):

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu \
        python scripts/check_long_schedules.py [train_4096] [prefill_8192] \
        [prefill_32768_1_layer] [prefill_32768] [granite_train_128] \
        [maverick_train_128_1_unit]
"""

from __future__ import annotations

import collections
import dataclasses
import json
import sys
import time

LLAMA, GRANITE = "llama3-8b", "granite-moe-1b-a400m"
MAVERICK = "llama4-maverick-400b-a17b"
# name -> (kind, seq, changes to the published config, arch)
ROWS = {"train_4096": ("train", 4096, {}, LLAMA),
        "prefill_8192": ("prefill", 8192, {}, LLAMA),
        "prefill_32768": ("prefill", 32768, {}, LLAMA),
        "prefill_32768_1_layer": ("prefill", 32768, {"n_layers": 1}, LLAMA),
        "granite_train_128": ("train", 128, {}, GRANITE),
        "maverick_train_128_1_unit": ("train", 128, {
            "n_layers": 2, "dtype": "float32", "grad_accum": 1,
            "fsdp": False}, MAVERICK)}


def _row(nd) -> tuple:
    return (nd.kind, tuple(nd.out_shape), nd.macs, nd.adds, nd.muls,
            nd.weight_shape, tuple(nd.deps), nd.repeat, nd.out_elems)


def check(name: str) -> dict:
    from repro.configs import get_config as ref_config
    from repro_torch import mapper
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.mapper import schedule as schedule_mod
    from test_torch_long_schedules import _oracle, _prefill_oracle

    kind, seq, changes, arch = ROWS[name]
    rcfg = dataclasses.replace(ref_config(arch), **changes)
    cfg = dataclasses.replace(get_config(arch), **changes)
    t0 = time.perf_counter()
    want = (_oracle(rcfg, 1, seq) if kind == "train"
            else _prefill_oracle(rcfg, 1, seq))
    t1 = time.perf_counter()
    if kind == "train":
        port = mapper.map_arch(arch, "train", batch=1, seq_len=seq,
                               config=cfg)
    else:
        port = schedule_mod.build_schedule(
            steps.make_prefill_step(cfg), steps.abstract_params(cfg),
            steps.input_specs(cfg, steps.ShapeSpec("prefill", seq, 1,
                                                   "prefill")))
    t2 = time.perf_counter()
    pn, wn = port.graph.nodes, want.graph.nodes
    rows_equal = ([_row(nd) for nd in pn] == [_row(nd) for nd in wn]
                  and [nd.name for nd in pn]
                  == [nd.name.replace("dot_general", "mm") for nd in wn])
    placement_equal = ({i: dataclasses.astuple(n) for i, n in
                        port.placement.node_placements.items()}
                       == {i: dataclasses.astuple(n) for i, n in
                           want.placement.node_placements.items()})
    got_rec = port.reconcile()

    def repeats(nodes):
        return dict(sorted(collections.Counter(nd.repeat
                                               for nd in nodes).items()))

    return {"row": name, "kind": kind, "seq_len": seq, "batch": 1,
            "config": f"{arch} published, {cfg.n_layers} layers, "
                      f"{cfg.dtype}",
            "nodes": [len(pn), len(wn)],
            "subarrays": [port.placement.n_subarrays,
                          want.placement.n_subarrays],
            "repeats_port": repeats(pn), "repeats_reference": repeats(wn),
            "aten_ops": len(port.graph.gm.graph.nodes),
            "rows_equal": rows_equal, "placement_equal": placement_equal,
            "report_equal": (dataclasses.astuple(port.report)
                             == dataclasses.astuple(want.report)),
            "reconcile_equal": got_rec == want.reconcile(),
            "counts_match": got_rec["counts_match"],
            "latency_ge_ideal": got_rec["latency_ge_ideal"],
            "reference_s": t1 - t0, "port_s": t2 - t1}


def main(argv: list[str]) -> int:
    names = argv or ["train_4096", "prefill_8192", "prefill_32768_1_layer"]
    unknown = [n for n in names if n not in ROWS]
    if unknown:
        print(f"unknown rows {unknown}; rows: {list(ROWS)}", file=sys.stderr)
        return 2
    ok = True
    for name in names:
        r = check(name)
        ok &= all(r[k] for k in ("rows_equal", "placement_equal",
                                 "report_equal", "reconcile_equal",
                                 "counts_match", "latency_ge_ideal"))
        print(json.dumps(r), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
