"""Model-server CLI: serve a model over HTTP with dynamic batching
(counterpart of ``vision_mtl_tpu/serve.py``).

    python -m vision_mtl_tpu_torch.serve --run_dir <version_dir> \
        [--host 127.0.0.1 --port 8008] [--buckets 1,4,8] [--max_wait_ms 2]
    python -m vision_mtl_tpu_torch.serve --demo --model_name mtan

Endpoints:

  * ``POST /predict`` — body is one ``.npy`` array (``np.save`` bytes) of
    shape ``(H, W, 3)`` or ``(N, H, W, 3)``, float (normalized) or uint8
    (raw; normalized to /255). Response: ``.npz`` bytes with ``segm``
    ``(N, H, W)`` int32 class ids and ``depth`` ``(N, H, W, 1)`` float32
    (uint8 and float16 with ``--compact_out``). Each image rides the dynamic
    batcher independently, so concurrent clients coalesce into full batches.
  * ``GET /healthz`` — liveness + model info (JSON).
  * ``GET /stats``   — request/batch/occupancy counters (JSON).

``--wire_dtype uint8`` takes raw uint8 images and normalizes them on the
device (the host-to-device transfer shrinks 4x); float bodies are then
rejected. ``--run_dir`` serves a run of ``python -m
vision_mtl_tpu_torch.training``: the model its ``train_args.yaml`` names,
with the weights of its newest ``model_{e}`` checkpoint. ``--demo`` serves
fresh seeded weights at the dataset's config.
"""

from __future__ import annotations

import argparse
import io
import json
import threading
import typing as t
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

#: refuse request bodies larger than this (bytes)
MAX_BODY_BYTES = 256 * 1024 * 1024


class _Handler(BaseHTTPRequestHandler):
    # set per-server via make_server()
    server: "MTLHTTPServer"

    def log_message(self, fmt: str, *args: t.Any) -> None:
        if self.server.verbose:
            super().log_message(fmt, *args)

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj: t.Any) -> None:
        self._send(code, json.dumps(obj).encode(), "application/json")

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        if self.path == "/healthz":
            self._send_json(200, {"ok": True, **self.server.model_info})
        elif self.path == "/stats":
            self._send_json(200, self.server.batcher.stats())
        else:
            self._send_json(404, {"error": f"unknown path {self.path}"})

    def do_POST(self) -> None:  # noqa: N802
        if self.path != "/predict":
            self._send_json(404, {"error": f"unknown path {self.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
        except ValueError:
            length = 0
        if length <= 0 or length > MAX_BODY_BYTES:
            self._send_json(
                400, {"error": f"bad Content-Length {length} (max {MAX_BODY_BYTES})"}
            )
            return
        body = self.rfile.read(length)
        try:
            imgs = np.load(io.BytesIO(body), allow_pickle=False)
        except Exception as e:
            self._send_json(400, {"error": f"body is not a .npy array: {e}"})
            return
        if not isinstance(imgs, np.ndarray):  # e.g. an .npz archive
            self._send_json(400, {"error": "body must be a single .npy array, not .npz"})
            return
        sample = self.server.sample_shape
        if imgs.shape == sample:
            imgs = imgs[None]
        if imgs.ndim != 4 or imgs.shape[1:] != sample:
            self._send_json(
                400,
                {"error": f"expected shape {sample} or (N,)+{sample}, got {tuple(imgs.shape)}"},
            )
            return
        if self.server.wire_dtype == np.uint8:
            # the batcher takes raw uint8; /255 happens on the device
            if imgs.dtype != np.uint8:
                self._send_json(
                    400,
                    {
                        "error": "server runs --wire_dtype uint8: send raw "
                        f"uint8 images, not {imgs.dtype}"
                    },
                )
                return
        elif imgs.dtype == np.uint8:
            imgs = imgs.astype(np.float32) / 255.0
        else:
            imgs = imgs.astype(np.float32, copy=False)
        try:
            futs = [self.server.batcher.submit(im) for im in imgs]
            outs = [f.result() for f in futs]
        except Exception as e:
            self._send_json(500, {"error": f"inference failed: {e}"})
            return
        buf = io.BytesIO()
        np.savez(
            buf,
            segm=np.stack([o["segm"] for o in outs]),
            depth=np.stack([o["depth"] for o in outs]),
        )
        self._send(200, buf.getvalue(), "application/octet-stream")


class MTLHTTPServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(
        self,
        addr: t.Tuple[str, int],
        batcher: t.Any,
        sample_shape: t.Tuple[int, int, int],
        model_info: t.Dict[str, t.Any],
        verbose: bool = False,
        wire_dtype: t.Any = np.float32,
    ):
        super().__init__(addr, _Handler)
        self.batcher = batcher
        self.sample_shape = sample_shape
        self.model_info = model_info
        self.verbose = verbose
        self.wire_dtype = np.dtype(wire_dtype).type


def make_server(
    batcher: t.Any,
    sample_shape: t.Tuple[int, int, int],
    model_info: t.Optional[t.Dict[str, t.Any]] = None,
    host: str = "127.0.0.1",
    port: int = 0,
    verbose: bool = False,
    wire_dtype: t.Any = np.float32,
) -> MTLHTTPServer:
    """Bind (but don't start) the HTTP front end; ``port=0`` picks a free
    port (``server.server_address[1]``). ``wire_dtype`` must match the
    batcher's image dtype."""
    return MTLHTTPServer(
        (host, port), batcher, sample_shape, model_info or {}, verbose,
        wire_dtype=wire_dtype,
    )


def serve_in_thread(server: MTLHTTPServer) -> threading.Thread:
    th = threading.Thread(target=server.serve_forever, name="vmtl-http-server", daemon=True)
    th.start()
    return th


def main(argv: t.Optional[t.Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--run_dir", default=None, help="training run version dir")
    p.add_argument(
        "--model_name",
        default=None,
        help="--demo: the model (default mtan); --run_dir: overrides train_args.yaml",
    )
    p.add_argument(
        "--dataset_name",
        default=None,
        help="--demo: the dataset config (default cityscapes); --run_dir: overrides "
        "train_args.yaml",
    )
    p.add_argument(
        "--demo",
        action="store_true",
        help="serve fresh seeded weights at the dataset's config (no --run_dir)",
    )
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8008)
    p.add_argument("--buckets", default="1,4,8", help="comma-separated batch bucket sizes")
    p.add_argument("--max_wait_ms", type=float, default=2.0)
    p.add_argument(
        "--wire_dtype",
        choices=("float32", "uint8"),
        default="float32",
        help="image dtype on the wire; uint8 shrinks the host-to-device transfer "
        "4x and normalizes on the device (clients must then send raw uint8)",
    )
    p.add_argument(
        "--compact_out",
        action="store_true",
        help="uint8 segm argmax + float16 depth in the .npz response",
    )
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)
    if bool(args.run_dir) == bool(args.demo):
        raise SystemExit("pass exactly one of --run_dir / --demo")

    from vision_mtl_tpu_torch.serving import BatchingServer

    buckets = tuple(int(b) for b in args.buckets.split(","))
    info: t.Dict[str, t.Any] = {}
    if args.run_dir:
        from vision_mtl_tpu_torch.pipeline import load_run_model

        model, data_cfg, run_args = load_run_model(
            args.run_dir, args.device, args.model_name, args.dataset_name
        )
        args.model_name, args.dataset_name = run_args.model_name, run_args.dataset_name
        info["run_dir"] = args.run_dir
    else:
        from vision_mtl_tpu_torch.cfg import fetch_data_cfg
        from vision_mtl_tpu_torch.models.registry import build_model

        args.model_name = args.model_name or "mtan"
        args.dataset_name = args.dataset_name or "cityscapes"
        data_cfg = fetch_data_cfg(args.dataset_name)
        model = build_model(args.model_name, data_cfg, device=args.device)
    info.update({
        "model": args.model_name,
        "dataset": args.dataset_name,
        "height": data_cfg.height,
        "width": data_cfg.width,
        "buckets": list(buckets),
        "wire_dtype": args.wire_dtype,
        "compact_out": args.compact_out,
        "device": args.device,
    })
    wire_dtype = np.dtype(args.wire_dtype).type
    batcher = BatchingServer(
        model,
        data_cfg.height,
        data_cfg.width,
        buckets=buckets,
        max_wait_ms=args.max_wait_ms,
        dtype=wire_dtype,
        compact_out=args.compact_out,
        device=args.device,
    )
    print(f"warming up {len(buckets)} buckets {list(buckets)} ...")
    batcher.warmup()
    batcher.reset_stats()
    server = make_server(
        batcher,
        (data_cfg.height, data_cfg.width, 3),
        info,
        host=args.host,
        port=args.port,
        verbose=args.verbose,
        wire_dtype=wire_dtype,
    )
    host, port = server.server_address[:2]
    print(f"serving {info['model']} on http://{host}:{port}  (POST /predict)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()


if __name__ == "__main__":
    main()
