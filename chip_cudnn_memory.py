"""Does basic's f32 train step depend on the device memory free when it
first runs? cuDNN picks a convolution's algorithm at the first call of its
shape in a process, among those whose workspace fits in the memory then
free, and keeps the pick.

    python3 chip_cudnn_memory.py        # on a machine with one card

Each run is a fresh process, on ``chip_smoke``'s seeded weights and batch
(Cityscapes 128x256, batch 8): basic's and basic ``fold_tail``'s f32 step
with the card to itself, twice; with a tensor holding all but 6 GB; then
under ``model:2`` over two gloo ranks sharing the card, with the parent
holding nothing and holding all but 10 GB. Prints one JSON line: each run's
relative L2 distance from the first (``chip_smoke.ZERO_GRAD`` left out),
its loss, and the cuDNN and cuBLAS kernels its profile shows beyond or
short of the first run's.
"""

import json
import os
import shutil
import subprocess
import sys

import torch

import chip_smoke as cs

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "cudnn_memory")
NAMES = ("basic", "basic_fold_tail")
# (run, free GB left to it, ranks, free GB the parent leaves to the ranks)
RUNS = (("alone", None, 1, None), ("alone_again", None, 1, None), ("6gb_free", 6, 1, None),
        ("model2", None, 2, None), ("model2_10gb_free", None, 2, 10))


def conv_kernels(prof) -> list:
    """Device kernels of convolutions and products in a profile."""
    words = ("conv", "fft", "winograd", "gemm", "dgrad", "wgrad", "implicit", "cudnn", "xmma",
             "cutlass")
    return sorted({e.key[:120] for e in prof.key_averages()
                   if e.device_type.name == "CUDA" and any(w in e.key.lower() for w in words)})


def step(name: str, mesh=None) -> tuple:
    """(loss, gradients gathered whole in f64 on the CPU, conv kernels) of
    one f32 train step of ``name``."""
    from vision_mtl_tpu_torch.cfg import fetch_data_cfg
    from vision_mtl_tpu_torch.metrics import init_metrics
    from vision_mtl_tpu_torch.models.registry import build_model
    from vision_mtl_tpu_torch.parallel.mesh import model_slices, shard_state
    from vision_mtl_tpu_torch.train.state import create_train_state
    from vision_mtl_tpu_torch.train.step import make_train_step

    cfg = fetch_data_cfg("cityscapes")
    dev = mesh.device if mesh is not None else torch.device("cuda")
    (batch,) = cs.train_batches(cfg, 1, cs.BATCH, seed=cs.PARALLEL_BATCH_SEED)
    base, options = cs.model_variant(name)
    model = build_model(base, cfg, dtype=torch.float32, device=dev, seed=0, **options)
    state = create_train_state(model, cs.LR, device=dev)
    if mesh is not None:
        state, batch = shard_state(state, mesh), mesh.block(batch)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, _, losses = make_train_step(device=dev, mesh=mesh)(
            state, batch, init_metrics(cfg.num_classes, dev))
        torch.cuda.synchronize()
    slices = model_slices(model)
    grads = {k: (slices[k].gather(p.grad) if k in slices else p.grad).double().cpu()
             for k, p in model.named_parameters()}
    return float(losses["loss"]), grads, conv_kernels(prof)


def child(run: str) -> int:
    """One run's process: its steps, saved under ``OUT`` (rank 0)."""
    from vision_mtl_tpu_torch import kernels
    from vision_mtl_tpu_torch.parallel import multihost
    from vision_mtl_tpu_torch.parallel.mesh import create_mesh

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build_all()  # built by the parent: loads them
    _, free_gb, ranks, _ = dict((r[0], r) for r in RUNS)[run]
    hold = None
    if free_gb is not None:
        free = torch.cuda.mem_get_info()[0]
        hold = torch.empty(int(free - free_gb * 2**30), dtype=torch.uint8, device="cuda")
    mesh = None
    if ranks > 1:
        multihost.maybe_initialize_distributed("cuda")
        mesh = create_mesh(f"model:{ranks}", multihost.current())
    for name in NAMES:
        loss, grads, convs = step(name, mesh)
        if mesh is None or mesh.rank == 0:
            torch.save({"loss": loss, "grads": grads, "kernels": convs,
                        "free_bytes": torch.cuda.mem_get_info()[0]},
                       os.path.join(OUT, f"{run}_{name}.pt"))
    del hold
    if mesh is not None:
        multihost.shutdown_distributed()
    return 0


def main() -> int:
    from vision_mtl_tpu_torch import kernels
    from vision_mtl_tpu_torch.parallel.multihost import free_port

    if not torch.cuda.is_available():
        print("chip_cudnn_memory: no CUDA device", file=sys.stderr)
        return 2
    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    kernels.build_all()
    for run, _, ranks, parent_free_gb in RUNS:
        hold = None
        if parent_free_gb is not None:
            free = torch.cuda.mem_get_info()[0]
            hold = torch.empty(int(free - parent_free_gb * 2**30), dtype=torch.uint8,
                               device="cuda")
        port, procs = free_port(), []
        for r in range(ranks):
            env = dict(os.environ)
            if ranks > 1:
                env.update(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(ranks),
                           LOCAL_WORLD_SIZE=str(ranks), MASTER_ADDR="127.0.0.1",
                           MASTER_PORT=str(port))
            procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), run],
                                          env=env))
        codes = [p.wait(timeout=600) for p in procs]
        del hold
        torch.cuda.empty_cache()
        if any(codes):
            print(f"chip_cudnn_memory: run {run} exited {codes}", file=sys.stderr)
            return 1
    out = {}
    for name in NAMES:
        first = torch.load(os.path.join(OUT, f"{RUNS[0][0]}_{name}.pt"))
        for run, *_ in RUNS:
            got = torch.load(os.path.join(OUT, f"{run}_{name}.pt"))
            whole, per = cs.grad_distance(got["grads"], first["grads"])
            out[f"{name} {run}"] = {
                "rel_l2_vs_first": whole,
                "worst_leaves": sorted(per.items(), key=lambda kv: -kv[1])[:2],
                "loss_equal": got["loss"] == first["loss"], "free_bytes": got["free_bytes"],
                "kernels_beyond_first": sorted(set(got["kernels"]) - set(first["kernels"])),
                "kernels_short_of_first": sorted(set(first["kernels"]) - set(got["kernels"]))}
    shutil.rmtree(OUT, ignore_errors=True)
    print(json.dumps({"cudnn_memory": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(child(sys.argv[1]) if sys.argv[1:] else main())
