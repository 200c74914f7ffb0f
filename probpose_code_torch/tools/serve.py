"""Serve a top-down pose model over HTTP.

The port's counterpart of the JAX package's ``tools/deployment/serve.py``:

    python -m probpose_code_torch.tools.serve CONFIG [CHECKPOINT]
        [--port 8080] [--host 127.0.0.1] [--device cpu]
    curl -X POST --data-binary @img.jpg http://127.0.0.1:8080/predict

A POSTed JPEG is decoded on the model's device (``ops/kernels/jpeg.py`` on
the card, the plain decoder on the CPU; EXIF orientation applied, as
``cv2.imdecode`` applies it), a PNG on the host; the whole image is one
box, and the answer
is a JSON list with ``keypoints`` and ``keypoint_scores`` for each instance,
as ``inference_topdown`` gives them. A body longer than 32 MiB (or empty)
gets 413; one that is not a decodable image, or any other failure, gets 400
with ``{"error": ...}``. The standard library's ``HTTPServer`` is
single-threaded: requests are served one at a time, which also serializes
the model. It binds 127.0.0.1 unless ``--host`` says otherwise; there is no
authentication. The model runs on the card unless ``--device cpu`` is
given, and ``init_model`` raises when CUDA is absent.
"""

from __future__ import annotations

import argparse
import json
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import List, Optional, Sequence

import numpy as np

from probpose_code_torch.apis.inference import inference_topdown, init_model
from probpose_code_torch.datasets.transforms.loading import read_image_bytes

MAX_BODY_BYTES = 32 * 1024 * 1024


def payload(samples) -> List[dict]:
    """The answer's JSON for ``inference_topdown``'s samples."""
    return [dict(keypoints=np.asarray(s.pred_instances.keypoints).tolist(),
                 keypoint_scores=np.asarray(s.pred_instances.keypoint_scores).tolist()) for s in samples]


def build_handler(model):
    class PoseHandler(BaseHTTPRequestHandler):
        def _reply(self, code: int, obj) -> None:
            out = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(out)))
            self.end_headers()
            self.wfile.write(out)

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            if length <= 0 or length > MAX_BODY_BYTES:
                self.send_error(413, f"Content-Length must be in (0, {MAX_BODY_BYTES}]")
                return
            try:
                image = read_image_bytes(self.rfile.read(length), "request body", model.device)
                self._reply(200, payload(inference_topdown(model, image)))
            except Exception as e:  # noqa: BLE001 - the client gets the error, the server goes on
                self._reply(400, dict(error=str(e)))

        def log_message(self, fmt, *args):  # quiet
            pass

    return PoseHandler


def make_server(model, host: str = "127.0.0.1", port: int = 8080) -> HTTPServer:
    """The server, bound (port 0: any free one, ``server.server_port``)
    but not yet serving: the caller runs ``serve_forever``."""
    return HTTPServer((host, port), build_handler(model))


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description="Serve a pose estimator over HTTP")
    parser.add_argument("config")
    parser.add_argument("checkpoint", nargs="?", default=None)
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--host", default="127.0.0.1",
                        help="bind address; no auth: expose beyond localhost only behind a trusted frontend")
    parser.add_argument("--device", default=None, help="the card unless 'cpu' is given")
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    model = init_model(args.config, args.checkpoint, device=args.device)
    server = make_server(model, args.host, args.port)
    print(f"serving pose model on {args.host}:{server.server_port} (POST an image to /predict)", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
