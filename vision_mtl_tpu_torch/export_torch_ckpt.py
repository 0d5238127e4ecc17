"""Export a run trained by the port into the reference's torch checkpoint
format (counterpart of ``scripts/export_torch_ckpt.py``): ``model_{e}.pt``
holding ``{"model": state_dict}`` in the reference's key layout, with the
Lightning wrapper's ``model.`` prefix, so a port run drops into an existing
PyTorch ``vision_mtl`` serving or evaluation stack, or into the JAX
package's reference importer.

    python -m vision_mtl_tpu_torch.export_torch_ckpt <run_dir> [--epoch N] [--out PATH] [--device cpu]

``run_dir`` is one of the port's run directories (``model_{e}/`` artifacts
and ``train_args.yaml``); the architecture comes from its own
``train_args.yaml``. Output defaults to ``<run_dir>/model_{e}.pt``; a path
ending in ``.npz`` writes a numpy archive instead. The model is rebuilt on
the card unless ``--device cpu`` is given, as for the other entry points.
"""

from __future__ import annotations

import argparse
import os
import typing as t

from vision_mtl_tpu_torch.device import resolve_device


def main(argv: t.Optional[t.Sequence[str]] = None) -> str:
    p = argparse.ArgumentParser()
    p.add_argument("run_dir")
    p.add_argument("--epoch", type=int, default=None, help="default: latest")
    p.add_argument("--out", default=None, help="default: <run_dir>/model_{e}.pt")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default: the card; raises without one) or 'cpu'.")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    from vision_mtl_tpu_torch.pipeline import load_run_model
    from vision_mtl_tpu_torch.train.checkpoint import _latest_epoch
    from vision_mtl_tpu_torch.utils.ckpt_import import save_reference_checkpoint

    if not os.path.exists(os.path.join(args.run_dir, "train_args.yaml")):
        raise SystemExit(
            f"{args.run_dir} has no train_args.yaml — cannot determine the "
            "architecture to export (pass a run dir written by training.main)"
        )
    epoch = args.epoch if args.epoch is not None else _latest_epoch(args.run_dir, "model")
    model, _, run_args = load_run_model(args.run_dir, device, epoch=epoch)
    out = args.out or os.path.join(args.run_dir, f"model_{epoch}.pt")
    save_reference_checkpoint(out, run_args.model_name, model)
    print(f"Exported {run_args.model_name} epoch {epoch} -> {out}")
    return out


if __name__ == "__main__":
    main()
