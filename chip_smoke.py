#!/usr/bin/env python3
"""On-card smoke test of garfield_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py

Needs one CUDA card and nvcc. It imports nothing of JAX or of the JAX
package, and runs these phases, each raising on failure:

  1. build: nvcc compiles every kernel source of garfield_tpu_torch/ops/csrc
     (in parallel, one nvcc per source); prints the build seconds;
  2. kernels against their plain PyTorch versions on the card, BITWISE:
     f32 and bf16, n in {1, 2, 8, 9, 32}, d not a multiple of the block,
     NaNs (up to ceil(n/2)-1 per column for the median, up to f for the
     trimmed mean), -0.0/+0.0 ties, the lie remap with its shared fake row,
     crash's zero scale over non-finite rows, reverse's -100 scale, and the
     trimmed mean at f in {1, 2};
  3. kernel timings at the main path's leaf shapes (the 62 leaves of
     ResNet-18 under folded lie, 8 workers, f = 2): the kernels, their
     plain versions and torch.median, with CUDA events after a synchronize,
     warm-up excluded, and the bytes/operations bound of the same work;
  4. the main path: ResNet-18 / CIFAR-10, 8 workers x batch 25, f = 2, lie
     folded into median and into tmean, through make_trainer (f32 with TF32
     off, and the bench's accelerator configuration: model and aggregation
     in bf16) and through the CLI; every step's loss must be finite, the
     parameters must move and each rule's kernel must launch exactly 62
     times per step (one per leaf). The launch counts are set to 0 just
     before this phase and read just after it.

The last two lines are the kernels' JSON line and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}};
the card's name and power limit (nvidia-smi) come on the line before them.
"""

import json
import math
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and f32 outside the
# tensor cores. The kernels compare and add in f32 on the CUDA cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

N_WORKERS, F, BATCH = 8, 2, 25
DEVICE = "cuda"
LEAVES = 62  # ResNet-18 parameter leaves: one kernel launch each per step


def log(*args):
    print(*args, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# --- phase 2: bitwise kernel checks -----------------------------------------


def _bits(t):
    import torch

    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def _same_bits(a, b):
    """Bitwise equal, a NaN counting equal to a NaN (payloads may differ)."""
    import torch

    same = (_bits(a) == _bits(b)) | (torch.isnan(a) & torch.isnan(b))
    return bool(same.all())


def _stack(rng, n, d, dtype, nan_max=0, signed_zeros=False):
    import torch

    x = rng.standard_normal((n, d)).astype(np.float32)
    if signed_zeros:
        cols = rng.random(d) < 0.25
        zeros = np.where(rng.random((n, d)) < 0.5, -0.0, 0.0).astype(np.float32)
        tie = (rng.random((n, d)) < 0.6) & cols[None, :]
        x = np.where(tie, zeros, x)
    if nan_max:
        # Up to nan_max NaNs per column, at random rows.
        for j in range(d):
            k = int(rng.integers(0, nan_max + 1))
            x[rng.choice(n, size=k, replace=False), j] = np.nan
    return torch.from_numpy(x).to(DEVICE, dtype)


def check_kernels_bitwise():
    import torch

    from garfield_tpu_torch import ops
    from garfield_tpu_torch.attacks import plan_gradient_attack_fold
    from garfield_tpu_torch.parallel.core import default_byz_mask

    rng = np.random.default_rng(20261017)
    cases = 0
    d = 3 * 256 + 77  # not a multiple of the 256-coordinate block
    for dtype in (torch.float32, torch.bfloat16):
        for n in (1, 2, 8, 9, 32):
            for nan in (False, True):
                for zeros in (False, True):
                    nan_max = (math.ceil(n / 2) - 1) if nan else 0
                    x = _stack(rng, n, d, dtype, nan_max, zeros)
                    got = ops.coordinate_median(x)
                    want = ops.coordinate_median_plain(x)
                    if not _same_bits(got, want):
                        raise AssertionError(
                            f"median kernel != plain: n={n} {dtype} "
                            f"nan={nan} zeros={zeros}")
                    cases += 1
                    for f in (1, 2):
                        if n - 2 * f < 1:
                            continue
                        x = _stack(rng, n, d, dtype, f if nan else 0, zeros)
                        got = ops.trimmed_mean(x, f)
                        want = ops.trimmed_mean_plain(x, f)
                        if not _same_bits(got, want):
                            raise AssertionError(
                                f"tmean kernel != plain: n={n} f={f} {dtype} "
                                f"nan={nan} zeros={zeros}")
                        cases += 1
            if n < 5:
                continue
            # Folded attacks: lie (remap onto one shared fake row passed as
            # a separate buffer), crash (zero scale over rows holding inf
            # and NaN: exact zeros), reverse (-100 scale).
            for attack in ("lie", "crash", "reverse"):
                mask = default_byz_mask(n, F)
                x = _stack(rng, n, d, dtype, signed_zeros=True)
                if attack == "crash":
                    rows = torch.as_tensor(np.flatnonzero(mask), device=DEVICE)
                    x[rows] = float("inf")
                    x[rows, ::7] = float("nan")
                plan = plan_gradient_attack_fold(attack, mask)
                extra = None
                if plan.build_extra is not None:
                    extra = plan.build_extra({"g": x})["g"]
                kw = dict(row_map=plan.row_map, row_scale=plan.row_scale,
                          extra=extra)
                pairs = [(ops.coordinate_median(x, **kw),
                          ops.coordinate_median_plain(x, **kw), "median")]
                for f in (1, 2):
                    pairs.append((ops.trimmed_mean(x, f, **kw),
                                  ops.trimmed_mean_plain(x, f, **kw),
                                  f"tmean f={f}"))
                for got, want, what in pairs:
                    if not _same_bits(got, want):
                        raise AssertionError(
                            f"{what} kernel != plain under {attack}: n={n} "
                            f"{dtype}")
                    if not bool(torch.isfinite(got).all()):
                        raise AssertionError(
                            f"{what} under {attack}: non-finite output")
                    cases += 1
    torch.cuda.synchronize()
    return cases


# --- phase 3: kernel timings at the step's leaf shapes ----------------------


def _events_ms(fn, reps):
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _device_ms(fn, names):
    """Device time (ms) of the kernels whose name contains one of ``names``
    during one call of ``fn``, from torch.profiler (CUPTI)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = 0.0
    for evt in prof.key_averages():
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and any(name in evt.key for name in names)):
            total += evt.self_device_time_total
    return total / 1e3


def _network_compare_exchanges(n):
    return sum(len(range(r % 2, n - 1, 2)) for r in range(n))


def time_kernels(dtype, reps=20):
    """Per step's worth of launches (62 leaves) at ResNet-18 shapes under
    folded lie: kernel, plain and library times, the bound, and the largest
    |kernel - plain|."""
    import torch

    from garfield_tpu_torch import models, ops
    from garfield_tpu_torch.attacks import plan_gradient_attack_fold
    from garfield_tpu_torch.parallel.core import default_byz_mask

    module = models.select_model("resnet18", "cifar10")
    sizes = [p.numel() for p in module.parameters()]
    assert len(sizes) == LEAVES, len(sizes)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    stack = {f"l{i}": torch.randn((N_WORKERS, s), generator=gen,
                                  device=DEVICE).to(dtype)
             for i, s in enumerate(sizes)}
    mask = default_byz_mask(N_WORKERS, F)
    plan = plan_gradient_attack_fold("lie", mask)
    extra = plan.build_extra(stack)
    kw = dict(row_map=plan.row_map, row_scale=plan.row_scale)
    # The poisoned (n, size) stacks, built only for torch.median's sake.
    logical = {k: torch.cat([g, extra[k][None]])[torch.as_tensor(
        plan.row_map, device=DEVICE, dtype=torch.long)]
        for k, g in stack.items()}

    d = sum(sizes)
    esize = torch.tensor([], dtype=dtype).element_size()
    distinct = N_WORKERS - F + 1  # honest rows + the shared fake row
    bytes_moved = (distinct + 1) * d * esize
    cx = _network_compare_exchanges(N_WORKERS)
    results = {}
    for op, kern, plain, lib in (
        ("coordinate_median",
         lambda g, e: ops.coordinate_median(g, extra=e, **kw),
         lambda g, e: ops.coordinate_median_plain(g, extra=e, **kw),
         lambda p: torch.median(p, dim=0).values),
        ("trimmed_mean",
         lambda g, e: ops.trimmed_mean(g, F, extra=e, **kw),
         lambda g, e: ops.trimmed_mean_plain(g, F, extra=e, **kw),
         None),
    ):
        # f32 operations per coordinate: 4 per compare-exchange (compare,
        # NaN test, two selects); the trimmed mean adds its chain and scale.
        ops_per_coord = 4 * cx + (
            (N_WORKERS - 2 * F) if op == "trimmed_mean" else 0)
        bound_bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        bound_ops_ms = ops_per_coord * d / F32_OPS_PER_S * 1e3
        err = 0.0
        for k, g in stack.items():
            diff = (kern(g, extra[k]).float()
                    - plain(g, extra[k]).float()).abs().max()
            err = max(err, float(diff))
        step_calls = lambda: [kern(g, extra[k]) for k, g in stack.items()]
        kernel_name = "median_kernel" if op == "coordinate_median" \
            else "tmean_kernel"
        row = {
            "ms": _events_ms(step_calls, reps),
            "device_ms": _device_ms(step_calls, [kernel_name]),
            "plain_ms": _events_ms(lambda: [plain(g, extra[k])
                                            for k, g in stack.items()],
                                   max(2, reps // 4)),
            "library_ms": None if lib is None else _events_ms(
                lambda: [lib(p) for p in logical.values()], reps),
            "bound_ms": max(bound_bytes_ms, bound_ops_ms),
            "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms
            else "operations",
            "max_abs_err": err,
            "bytes": bytes_moved,
            "ops": ops_per_coord * d,
        }
        if err != 0.0:
            raise AssertionError(f"{op} {dtype}: kernel != plain ({err})")
        results[op] = row
    return results


# --- phase 4: the main path --------------------------------------------------


def _flat_params(state):
    import torch

    return torch.cat([p.detach().float().reshape(-1)
                      for p in state.params.values()])


def _profile_steps(step_fn, state, x, y, steps=2):
    """Device busy time per step and the kernels that take it, from
    torch.profiler over ``steps`` steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state, _ = step_fn(state, x, y)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps * 1e3
    # Device-side events only (kernels, copies): the aten ops that launch
    # them carry the same time again.
    rows = [(evt.self_device_time_total, evt.count, evt.key)
            for evt in prof.key_averages()
            if evt.device_type == torch.autograd.DeviceType.CUDA
            and not evt.is_user_annotation]
    busy = sum(r[0] for r in rows) / steps / 1e3
    top = sorted(rows, reverse=True)[:6]
    return state, {
        "wall_ms": wall, "device_busy_ms": busy,
        "top": [(key[:60], t / steps / 1e3, c // steps) for t, c, key in top],
    }


def run_trainer(gar, dtype, gar_dtype, steps, warmup=1, profile=False):
    """make_trainer on ResNet-18/CIFAR-10 shapes, lie folded into ``gar``;
    returns the step time (ms, CUDA events, warm-up excluded) and, with
    ``profile``, the device busy time of two more (profiled) steps."""
    import torch

    from garfield_tpu_torch import models, ops
    from garfield_tpu_torch.parallel import aggregathor
    from garfield_tpu_torch.utils import selectors

    module = models.select_model("resnet18", "cifar10", dtype=dtype)
    init_fn, step_fn, _ = aggregathor.make_trainer(
        module, selectors.select_loss("cross-entropy"),
        selectors.select_optimizer("sgd", lr=0.2, momentum=0.9,
                                   weight_decay=5e-4),
        gar, num_workers=N_WORKERS, f=F, attack="lie", gar_dtype=gar_dtype,
        device=DEVICE,
    )
    rng = np.random.default_rng(1234)  # bench.py's batch
    x = torch.as_tensor(rng.standard_normal(
        (N_WORKERS, BATCH, 32, 32, 3)), dtype=torch.float32, device=DEVICE)
    y = torch.as_tensor(rng.integers(0, 10, (N_WORKERS, BATCH)),
                        device=DEVICE)
    state = init_fn(1234)
    before = _flat_params(state)
    op = "coordinate_median" if gar == "median" else "trimmed_mean"
    count0 = ops.launches[op]
    losses = []
    for _ in range(warmup):
        state, m = step_fn(state, x, y)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        state, m = step_fn(state, x, y)
        losses.append(m["loss"])
    stop.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(stop) / steps
    done = warmup + steps
    prof = None
    if profile:
        state, prof = _profile_steps(step_fn, state, x, y)
        done += 2
    losses = [float(v) for v in losses]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{gar} {dtype}: non-finite loss {losses}")
    after = _flat_params(state)
    if not bool(torch.isfinite(after).all()):
        raise AssertionError(f"{gar} {dtype}: non-finite parameters")
    moved = float((after - before).norm())
    if not moved > 0:
        raise AssertionError(f"{gar} {dtype}: the parameters did not move")
    launched = ops.launches[op] - count0
    if launched != LEAVES * done:
        raise AssertionError(
            f"{gar} {dtype}: {launched} {op} launches for {done} steps, "
            f"expected {LEAVES} per step")
    return {"step_ms": step_ms, "losses": losses, "param_delta": moved,
            "launches_per_step": launched / done,
            "profile": prof}


def run_cli():
    from garfield_tpu_torch import ops
    from garfield_tpu_torch.apps import aggregathor as cli

    count0 = ops.launches["coordinate_median"]
    steps = 3
    _, summary = cli.main([
        "--dataset", "cifar10", "--model", "resnet18", "--batch",
        str(BATCH), "--num_workers", str(N_WORKERS), "--fw", str(F),
        "--gar", "median", "--attack", "lie", "--loss", "cross-entropy",
        "--optimizer", "sgd", "--opt_args",
        '{"lr":"0.2","momentum":"0.9","weight_decay":"0.0005"}',
        "--num_iter", str(steps), "--acc_freq", "0", "--bench",
        "--device", DEVICE,
    ])
    launched = ops.launches["coordinate_median"] - count0
    if launched != LEAVES * steps:
        raise AssertionError(f"CLI: {launched} median launches in {steps} steps")
    if not math.isfinite(summary["final_loss"]):
        raise AssertionError(f"CLI: non-finite loss {summary}")
    if not 0.0 <= summary["final_accuracy"] <= 1.0:
        raise AssertionError(f"CLI: accuracy out of range {summary}")
    return summary


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 2
    from garfield_tpu_torch import ops
    from garfield_tpu_torch.ops import _build

    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    # Phase 1: build.
    t0 = time.perf_counter()
    built = _build.build()
    for src, (secs, ptxas) in built.items():
        log(f"build: {src} in {secs:.1f} s")
        regs = sorted({line.split("Used")[1].split(",")[0].strip()
                       for line in ptxas.splitlines() if "Used" in line})
        log(f"build: ptxas register use over the instantiations: {regs}")
    log(f"build: total {time.perf_counter() - t0:.1f} s")

    # Phase 2: kernels against their plain versions, bitwise.
    cases = check_kernels_bitwise()
    log(f"kernels: {cases} cases bitwise equal to the plain versions")

    # Phase 3: kernel timings at the main path's leaf shapes.
    timings = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        timings[name] = time_kernels(dtype)
        for op, row in timings[name].items():
            log(f"kernel {op} [{name}] per step (62 launches): "
                f"{row['ms']:.4f} ms (device {row['device_ms']:.4f} ms), "
                f"plain {row['plain_ms']:.4f} ms, "
                f"torch.median {row['library_ms']} ms, bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']}: "
                f"{row['bytes']} B, {row['ops']} f32 ops)")

    # Phase 4: the main path. f32 runs with TF32 off in cuDNN and cuBLAS,
    # so f32 means f32 (PyTorch's default runs f32 convolutions in TF32).
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("main path: torch.backends.cudnn.allow_tf32=False, "
        "torch.backends.cuda.matmul.allow_tf32=False")
    ops.reset_launches()
    runs = {}
    for gar in ("median", "tmean"):
        for name, dtype, gar_dtype in (
            ("f32", torch.float32, None),
            ("bf16", torch.bfloat16, torch.bfloat16),
        ):
            r = run_trainer(gar, dtype, gar_dtype, steps=5, profile=True)
            runs[(gar, name)] = r
            log(f"step {gar}+lie [{name}]: {r['step_ms']:.3f} ms/step "
                f"(8 workers x 25, ResNet-18), losses "
                f"{[round(v, 4) for v in r['losses']]}, "
                f"{r['launches_per_step']:.0f} launches/step")
            prof = r["profile"]
            idle = 1.0 - prof["device_busy_ms"] / r["step_ms"]
            log(f"  profile: device busy {prof['device_busy_ms']:.3f} "
                f"ms/step, idle share {idle:.3f} of the unprofiled step "
                f"(profiled wall {prof['wall_ms']:.3f} ms/step); top "
                f"kernels (ms/step, launches/step): {prof['top']}")
    summary = run_cli()
    log(f"cli: median+lie 3 steps, step median "
        f"{summary['step_median_s'] * 1e3:.3f} ms, final loss "
        f"{summary['final_loss']:.4f}, accuracy {summary['final_accuracy']}")
    launches = dict(ops.launches)
    for op in launches:
        if launches[op] == 0:
            raise AssertionError(f"{op} never launched on the main path")

    replaces = {"coordinate_median": "garfield_tpu/ops/coordinate.py:150",
                "trimmed_mean": "garfield_tpu/ops/coordinate.py:155"}
    kernels = []
    for op in ("coordinate_median", "trimmed_mean"):
        row = timings["f32"][op]
        kernels.append({
            "name": op, "route": "cuda",
            "source": "garfield_tpu_torch/ops/csrc/coordinate.cu",
            "replaces": replaces[op], "launches": launches[op],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
    log(card)  # as nvidia-smi gives it: name, power limit
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
