"""HTTP serving front end over Predictor and ServingQueue (retr_tpu/serve.py; stdlib only).

    python -m retr_tpu_torch.serve --checkpoint Concat_refcoco_checkpoint_7.pth \\
        [--host 127.0.0.1] [--port 8000] [--max-batch 32] [--decoder greedy] \\
        [--max-wait-s 0.05] [--max-queued N] [--allow-local-paths ROOT] [--device cuda]

Endpoints:
- ``POST /predict``  body ``{"image": <base64 PNG/JPEG> | "image_path": <path under
  the --allow-local-paths root; off by default>, "bbox": [x, y, w, h]}`` ->
  ``{"expression": "..."}``. Concurrent requests are batched by the
  ServingQueue. Under overload the bounded admission queue sheds: HTTP 503
  with a Retry-After header (and ``retry_after_s`` in the body). A malformed
  request gets 400 with the exception's type name only.
- ``GET /healthz``  -> ``{"ok": true, "device": "...", "queue": {admission stats}}``;
  on the card ``device`` names it (``torch.cuda.get_device_name``).

SIGTERM and Ctrl-C stop accepting and drain the queue before the process exits.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import os
import signal
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from retr_tpu_torch.data.preprocess import load_image
from retr_tpu_torch.predictor import Predictor, ServingOverloaded, ServingQueue


def _decode_image(payload: dict, image_root: Optional[str] = None) -> np.ndarray:
    if "image" in payload:
        from PIL import Image

        raw = base64.b64decode(payload["image"])
        return np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))
    if "image_path" in payload:
        # 'image_path' reads files of the server's host: off unless the operator
        # named a root, and then only paths inside it (symlinks resolved), so a
        # client cannot probe other files through the image loader
        if image_root is None:
            raise ValueError("'image_path' is disabled (start with --allow-local-paths)")
        root = os.path.realpath(image_root)
        p = os.path.realpath(os.path.join(root, payload["image_path"]))
        if os.path.commonpath([p, root]) != root:
            raise ValueError("image_path escapes the allowed root")
        return load_image(p)
    raise ValueError("request needs 'image' (base64) or 'image_path'")


def device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return f"{device} ({torch.cuda.get_device_name(device)})"
    return str(device)


def make_server(queue: ServingQueue, host: str = "127.0.0.1", port: int = 8000,
                request_timeout_s: float = 120.0, image_root: Optional[str] = None) -> ThreadingHTTPServer:
    """Build (not start) the HTTP server bound to a ServingQueue."""
    device = device_name(queue.predictor.device)

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, obj: dict, headers: Optional[dict] = None) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (http.server API)
            if self.path == "/healthz":
                self._send(200, {"ok": True, "device": device, "queue": queue.stats()})
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):  # noqa: N802
            if self.path != "/predict":
                self._send(404, {"error": "unknown path"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length) or b"{}")
                img = _decode_image(payload, image_root)
                fut = queue.submit(img, payload["bbox"])
                self._send(200, {"expression": fut.result(timeout=request_timeout_s)})
            except ServingOverloaded as exc:
                self._send(503, {"error": "overloaded", "retry_after_s": round(exc.retry_after_s, 3)},
                           headers={"Retry-After": str(max(1, int(round(exc.retry_after_s))))})
            except Exception as exc:  # one request's failure: 400, the server stays up
                # the body names the type only: exception text can echo paths
                self._send(400, {"error": type(exc).__name__})

        def log_message(self, *args):  # quiet by default
            pass

    return ThreadingHTTPServer((host, port), Handler)


def run_in_thread(queue: ServingQueue, host: str = "127.0.0.1", port: int = 0,
                  image_root: Optional[str] = None):
    """Start the server (port 0: an ephemeral one) in a daemon thread; returns
    (server, base_url). Stop it with ``server.shutdown()``."""
    server = make_server(queue, host, port, image_root=image_root)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://{server.server_address[0]}:{server.server_address[1]}"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--checkpoint", required=True, help="a reference .pth checkpoint")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--max-wait-s", type=float, default=0.05)
    ap.add_argument("--max-queued", type=int, default=None,
                    help="admission bound: requests queued beyond it get HTTP 503 + Retry-After "
                    "(default 4 * max_batch)")
    ap.add_argument("--decoder", default="greedy", choices=["greedy", "beam", "sample"])
    ap.add_argument("--allow-local-paths", default=None, metavar="ROOT",
                    help="enable 'image_path' requests, restricted to this directory")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; 'cpu' runs the plain path)")
    args = ap.parse_args(argv)

    pred = Predictor.from_checkpoint(args.checkpoint, max_batch=args.max_batch, device=args.device)
    queue = ServingQueue(pred, max_wait_s=args.max_wait_s, decoder=args.decoder, max_queued=args.max_queued)
    server = make_server(queue, args.host, args.port, image_root=args.allow_local_paths)
    print(f"serving on http://{args.host}:{server.server_address[1]} (decoder={args.decoder}, "
          f"max_batch={args.max_batch}, device={device_name(pred.device)})", flush=True)

    def _term(signum, frame):  # SIGTERM takes Ctrl-C's path: stop, then drain
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _term)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        queue.close(wait=True)


if __name__ == "__main__":
    main()
