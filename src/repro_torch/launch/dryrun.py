"""Multi-pod dry run: prove the serving distribution is coherent (port of
``src/repro/launch/dryrun.py``).

For every (architecture x input shape x mesh) combination this builds the
production step (serve prefill for prefill_32k, the one-token cached
decode step for decode_32k / long_500k) over a 16 x 16 (or 2 x 16 x 16)
mesh in a fake process group of 256 (512) ranks (``launch/mesh.py:
fake_world``), traces it on fake local shards, and records

  * the per-device memory: argument, temp (the peak of live storages)
    and output bytes of rank 0's shards;
  * the collectives the trace dispatched, by kind
    (``roofline/comm_count.py``);
  * the three roofline terms at H100 constants (the analytic FLOPs / HBM
    model plus the counted collectives).

Nothing touches a device: the shards are fake tensors and every
collective of the fake backend returns at once. Configs are cast to
bfloat16, as the reference's. Shapes of kind ``train`` are recorded as
skipped: the training lowering comes with the next slice.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape decode_32k
  python -m repro_torch.launch.dryrun --all --out build/dryrun/dryrun.json
  python -m repro_torch.launch.dryrun --all --multi-pod
"""

import argparse
import json
import os
import time
import traceback

TRAIN_SKIP = ("the training lowering comes with the next slice "
              "(ROADMAP.md Queue 1)")


def run_one(arch: str, shape_name: str, *, multi_pod: bool,
            verbose: bool = True) -> dict:
    """One cell, inside a running ``fake_world`` of the mesh's size."""
    from repro_torch.configs import INPUT_SHAPES, get_config, supports_shape
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.roofline.analysis import analyze_lowered
    from repro_torch.roofline.flops import cost_for

    mesh_name = "2x16x16" if multi_pod else "16x16"
    shape = INPUT_SHAPES[shape_name]
    cfg = get_config(arch).with_dtype("bfloat16")
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "status": "ok"}

    ok, why = supports_shape(cfg, shape)
    if ok and shape.kind == "train":
        ok, why = False, TRAIN_SKIP
    if not ok:
        rec.update(status="skipped", reason=why)
        if verbose:
            print(f"[dryrun] SKIP {arch} x {shape_name} x {mesh_name}: {why}")
        return rec

    mesh = make_production_mesh(multi_pod=multi_pod)
    n_devices = mesh.size()
    t0 = time.time()
    if shape.kind == "prefill":
        from repro_torch.launch.serve import lower_prefill

        lowered = lower_prefill(arch, mesh, shape_name=shape_name)
    else:
        from repro_torch.launch.serve import lower_decode

        lowered = lower_decode(arch, mesh, shape_name=shape_name)
    t_lower = time.time() - t0

    t0 = time.time()
    traced = lowered.trace()
    t_trace = time.time() - t0

    mem = traced["memory"]
    cost = cost_for(cfg, shape, n_devices=n_devices)
    report = analyze_lowered(
        arch=arch, shape=shape_name, mesh_name=mesh_name,
        n_devices=n_devices, cost=cost, collectives=traced["collectives"],
        memory=mem, dtype=cfg.dtype)

    if verbose:
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: "
              f"lower {t_lower:.1f}s trace {t_trace:.1f}s")
        print(f"  memory:          args={mem['argument_bytes']/1e9:.3f}GB "
              f"temp={mem['temp_bytes']/1e9:.3f}GB "
              f"out={mem['output_bytes']/1e9:.3f}GB per device")
        print(f"  collectives:     {report.collective_detail['bytes_by_kind']}")
        print(f"  roofline terms:  compute={report.compute_s*1e3:.3f}ms "
              f"memory={report.memory_s*1e3:.3f}ms "
              f"collective={report.collective_s*1e3:.3f}ms "
              f"-> {report.bottleneck}-bound (H100 constants)")

    rec.update(
        lower_s=round(t_lower, 2),
        trace_s=round(t_trace, 2),
        memory=dict(mem),
        roofline=report.as_dict(),
    )
    return rec


def merge_results(path: str, records: list[dict]) -> None:
    data = {}
    if os.path.exists(path):
        with open(path) as f:
            data = json.load(f)
    for r in records:
        data[f"{r['arch']}|{r['shape']}|{r['mesh']}"] = r
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=1)
    os.replace(tmp, path)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every (arch x shape) for the chosen mesh")
    ap.add_argument("--out", default="build/dryrun/dryrun.json")
    args = ap.parse_args(argv)

    from repro_torch.configs import ASSIGNED, INPUT_SHAPES
    from repro_torch.launch.mesh import fake_world

    if args.all:
        combos = [(a, s) for a in ASSIGNED for s in INPUT_SHAPES]
    elif args.arch and args.shape:
        combos = [(args.arch, args.shape)]
    else:
        ap.error("pass --arch and --shape, or --all")

    records, failures = [], 0
    with fake_world(512 if args.multi_pod else 256):
        for arch, shape in combos:
            try:
                rec = run_one(arch, shape, multi_pod=args.multi_pod)
            except Exception as e:  # a failure here is a sharding bug: report it
                failures += 1
                rec = {"arch": arch, "shape": shape,
                       "mesh": "2x16x16" if args.multi_pod else "16x16",
                       "status": "error", "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-2000:]}
                print(f"[dryrun] ERROR {arch} x {shape}: {e}")
            records.append(rec)
            merge_results(args.out, records)  # persist incrementally
    print(f"[dryrun] done: {len(records) - failures}/{len(records)} OK "
          f"-> {args.out}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
