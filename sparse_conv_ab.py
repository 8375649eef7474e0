"""Time the sparse convolution's CUDA kernels of one source tree on the
card, at SECOND's shapes, so that two commits can be compared on one card:

* the 12 fp32 forwards at a train step's layers (the fixture's batch of
  4, recorded from one fp32 train-mode forward) and at the served layers
  (the 8 scans: fp32 copies of one bf16 forward's inputs);
* the train step's 11 data gradients (each with its table's transpose)
  and 12 weight gradients, on a seeded cotangent;
* the train step's transposition: every table transpose its data
  gradients launch (a tree whose convs hand their backward no transpose
  geometry scatters each of the 11 layers' tables,
  ``sparse_conv.sparse_conv_transpose``; one that does builds the 4
  strided layers' tables, ``lookup.transposed_table``, and runs the 7
  submanifold ones on their own tables), per layer and as one sequence,
  and the 11 data gradients as one sequence; where the tree has one, an
  empty kernel's time in a CUDA graph (a launch's latency floor);
* the 12 bf16 served forwards.

Each is timed by CUDA events over back-to-back calls and in a CUDA graph
(``chip_smoke.time_ms`` / ``graph_ms``), per layer and summed. Run it once
per tree in turns (parent, change, change, parent) within one call:

    python3 sparse_conv_ab.py --tree /path/to/parent --label parent
    python3 sparse_conv_ab.py --label change

``--tree`` is a checkout whose ``de6d_tpu_torch`` is imported (and whose
kernels are built) instead of this one's; the inputs and the timing come
from this checkout's ``chip_smoke.py``. Prints each group's totals and
per-layer ms and the card's name and power limit, and writes every
number, with how many of the gather kernel's instantiations spill
registers in this build (``ptxas -v``), to
``chiprun_out/sparse_conv_ab_<label>.json``. Needs a card.
"""

import argparse
import importlib.util
import json
import re
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=HERE,
                    help="checkout whose de6d_tpu_torch is timed")
    ap.add_argument("--label", default="this")
    args = ap.parse_args()
    sys.path.insert(0, str(args.tree.resolve()))
    import torch

    if not torch.cuda.is_available():
        sys.exit("sparse_conv_ab: needs a CUDA device")
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from de6d_tpu_torch.ops.kernels import build
    from de6d_tpu_torch.ops.kernels import sparse_conv as sc

    assert Path(sc.__file__).resolve().is_relative_to(args.tree.resolve())
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    build.build()
    built_s = time.perf_counter() - t0
    (HERE / "chiprun_out").mkdir(exist_ok=True)
    (HERE / "chiprun_out" / f"ptxas_{args.label}.txt").write_text(
        build.build_info.get("ptxas", ""))

    train = cs.recorded_second_train_convs("cuda")
    gen = torch.Generator(device="cuda").manual_seed(13)
    dys = {k: torch.randn((*c[1].shape[:2], c[3].shape[2]), generator=gen,
                          device="cuda") for k, c in train.items()}
    model = cs.build_model("bfloat16", "cuda", cs.SECOND_CFG,
                           cs.SECOND_PARAMS)[0]
    pts, mask = cs.load_second_scans()
    with torch.no_grad(), cs.recorded_sparse_calls() as calls:
        model({"points": torch.from_numpy(pts).cuda(),
               "points_mask": torch.from_numpy(mask).cuda()})
    served = dict(zip(cs.SECOND_CONVS, (a for a, _ in calls["sparse_conv"])))
    served32 = {k: tuple(t.float() if t.is_floating_point() else t
                         for t in a) for k, a in served.items()}
    del model, calls

    def timed(fn):
        return {"ms": cs.time_ms(fn, 10), "graph_ms": cs.graph_ms(fn)}

    # how this tree's data gradient gets its table's transpose
    mirrored_tree = hasattr(sc, "Submanifold")
    if mirrored_tree:
        from de6d_tpu_torch.ops.kernels import lookup

    def dgrad(dy, idx, hit, w, valid, v, tr):
        if mirrored_tree:
            return lambda: sc.sparse_conv_dgrad(dy, idx, hit, w, valid, v, tr)
        return lambda: sc.sparse_conv_dgrad(dy, idx, hit, w, valid, v)

    def transposition(idx, hit, valid, v, tr):
        """The layer's table transpose as its data gradient launches it,
        or None where it launches none."""
        if not mirrored_tree:
            return lambda: sc.sparse_conv_transpose(idx, hit, valid, v)
        if isinstance(tr, sc.Strided):
            return lambda: lookup.transposed_table(*tr)
        return None

    def err(a, b):
        return float((a.float() - b.float()).abs().max())

    out = {"label": args.label, "tree": str(args.tree), "build_s": built_s}
    groups = {}
    dgrads, tables = [], []
    for label, (f, idx, hit, w, valid, tr) in train.items():
        v, dy = f.shape[1], dys[label]
        row = groups.setdefault("train_fp32_forward", {})
        row[label] = timed(lambda: sc.sparse_conv(f, idx, hit, w, valid))
        row[label]["max_abs_err"] = err(
            sc.sparse_conv(f, idx, hit, w, valid),
            sc.sparse_conv_plain(f, idx, hit, w, valid))
        if label != "subm_s1_in":
            dgrads.append(dgrad(dy, idx, hit, w, valid, v, tr))
            groups.setdefault("train_dgrad", {})[label] = timed(dgrads[-1])
            table = transposition(idx, hit, valid, v, tr)
            row = groups.setdefault("train_transposition", {})
            row[label] = {"launches": 0, "ms": 0.0, "graph_ms": 0.0}
            if table is not None:
                tables.append(table)
                row[label] = {"launches": 1, **timed(table)}
        groups.setdefault("train_wgrad", {})[label] = timed(
            lambda: sc.sparse_conv_wgrad(f, dy, idx, hit, valid))
    for name, fns in (("train_dgrad_sequence", dgrads),
                      ("train_transposition_sequence", tables)):
        groups[name] = {"all": {"launches": len(fns), **timed(
            lambda fns=fns: [fn() for fn in fns])}}
    for label, a in served32.items():
        row = groups.setdefault("serve_fp32_forward", {})
        row[label] = {**timed(lambda: sc.sparse_conv(*a)),
                      "max_abs_err": err(sc.sparse_conv(*a),
                                         sc.sparse_conv_plain(*a))}
    for label, a in served.items():
        groups.setdefault("serve_bf16_forward", {})[label] = timed(
            lambda: sc.sparse_conv(*a))
    for name, rows in groups.items():
        keys = next(iter(rows.values())).keys()
        out[name] = {"total": {k: sum(r[k] for r in rows.values())
                               if k != "max_abs_err" else
                               max(r[k] for r in rows.values())
                               for k in keys},
                     "layers": rows}
    if mirrored_tree and hasattr(lookup, "empty_kernel"):
        out["empty_kernel_graph_ms"] = cs.graph_ms(
            lambda: lookup.empty_kernel("cuda"))
    # gather-kernel instantiations that spill, from this build's ptxas -v
    spills = [int(n) for n in re.findall(
        r"sparse_conv_gather_kernel.*?\n.*?(\d+) bytes spill stores",
        build.build_info.get("ptxas", ""))]
    if spills:
        out["gather_spills"] = {"instantiations": len(spills),
                                "spilling": sum(n > 0 for n in spills)}
    out["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out["device"] = torch.cuda.get_device_name(0)
    line = json.dumps(out)
    (HERE / "chiprun_out" / f"sparse_conv_ab_{args.label}.json").write_text(
        line)
    for name, rows in groups.items():
        t = out[name]["total"]
        print(f"sparse_conv_ab {args.label} {name}: "
              + ", ".join(f"{k} {x:.4f}" for k, x in t.items()) + "; ms "
              + " ".join(f"{k} {r['ms']:.4f}" for k, r in rows.items()),
              flush=True)
    print(f"sparse_conv_ab {args.label}: {out['device']}, "
          f"{out['nvidia_smi']}, build {built_s:.1f} s, an empty kernel "
          f"{out.get('empty_kernel_graph_ms', float('nan')):.5f} ms in a "
          "graph", flush=True)


if __name__ == "__main__":
    main()
