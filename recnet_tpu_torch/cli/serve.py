"""CLI: a minimal HTTP captioning service around serving.Captioner.

Port of ``recnet_tpu.cli.serve``, with the same JSON protocol:

  python -m recnet_tpu_torch.cli.serve --ckpt checkpoints/<run>/<step> \\
      --use_pallas --greedy_segment 4

  POST /caption   {"features": [[[f...] x frames] x n_videos]}
  -> {"captions": ["a man is ...", ...]}

  GET /healthz    -> {"ok": true, "model": "<run id>", "requests": N, ...}

Status codes: 400 for a malformed request, 404 for an unknown path, 503
when the micro-batch queue is full, 504 past the deadline, 500 for a
runtime failure (a beam request, until beam search is ported).
Concurrent requests are micro-batched unless ``--sequential``.
"""

from __future__ import annotations

import argparse
import json
from http.server import (BaseHTTPRequestHandler, HTTPServer,
                         ThreadingHTTPServer)

import numpy as np

from recnet_tpu_torch.serving import DeadlineExceeded, ServiceOverloaded


def make_handler(captioner, model_id: str):
    """``captioner`` is anything with .caption(feats, beam_width): the raw
    Captioner (sequential) or a MicroBatcher in front of it."""
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                payload = {"ok": True, "model": model_id}
                for attr, name in (("n_requests", "requests"),
                                   ("n_dispatches", "dispatches"),
                                   ("n_coalesced", "coalesced"),
                                   ("n_rejected", "rejected"),
                                   ("n_expired", "expired")):
                    if hasattr(captioner, attr):
                        payload[name] = getattr(captioner, attr)
                return self._reply(200, payload)
            return self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/caption":
                return self._reply(404, {"error": "unknown path"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                feats = [np.asarray(f, np.float32) for f in req["features"]]
                if not feats:
                    return self._reply(400, {"error": "no features"})
                for f in feats:
                    if f.ndim != 2:
                        return self._reply(400, {
                            "error": "each feature must be (frames, feat)"})
                beam = req.get("beam")
                captions = captioner.caption(
                    feats, beam_width=int(beam) if beam else None)
                return self._reply(200, {"captions": captions})
            except ServiceOverloaded as e:
                return self._reply(503, {"error": str(e)})
            except DeadlineExceeded as e:
                return self._reply(504, {"error": str(e)})
            except (KeyError, ValueError, TypeError) as e:
                return self._reply(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — a runtime failure must
                # reach the client as a 5xx, not a dropped connection
                return self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def main(argv=None):
    from recnet_tpu_torch.serving import Captioner, MicroBatcher

    a = argparse.ArgumentParser()
    a.add_argument("--ckpt", required=True, help="checkpoint step directory")
    a.add_argument("--host", default="127.0.0.1")
    a.add_argument("--port", type=int, default=8000)
    a.add_argument("--device", default="cuda",
                   help="torch device to decode on (default cuda)")
    a.add_argument("--batch_size", type=int, default=1024)
    a.add_argument("--dtype", choices=["bfloat16", "float32"],
                   default="bfloat16")
    a.add_argument("--sequential", action="store_true",
                   help="serve one request at a time (no micro-batching, "
                        "no handler threads)")
    a.add_argument("--flush_ms", type=float, default=6.0,
                   help="micro-batch flush window: how long a dispatch "
                        "waits for concurrent requests to coalesce")
    a.add_argument("--max_queue", type=int, default=0,
                   help="bound on requests waiting for dispatch; when "
                        "full, new requests get HTTP 503 (0 = unbounded)")
    a.add_argument("--deadline_s", type=float, default=0.0,
                   help="per-request wall budget from enqueue; requests "
                        "still queued past it get HTTP 504 (0 = none)")
    a.add_argument("--beam_length_margin", type=int, default=-1,
                   help="approximate beam cutoff (beam search is not "
                        "ported yet; kept for flag parity)")
    a.add_argument("--use_pallas", action="store_true",
                   help="decode with the hand-written whole-decode kernels "
                        "(1-layer GRU/LSTM; decoding.kernels_supported)")
    a.add_argument("--greedy_segment", type=int, default=0,
                   help="with --use_pallas: decode in N-step kernel "
                        "segments and stop once every row has an <EOS> "
                        "(0 = one whole-decode launch)")
    args = a.parse_args(argv)
    if args.sequential and (args.max_queue or args.deadline_s):
        a.error("--max_queue/--deadline_s need the micro-batched "
                "front (drop --sequential)")

    cap = Captioner.from_checkpoint(
        args.ckpt, dtype=args.dtype, batch_size=args.batch_size,
        use_pallas=args.use_pallas, device=args.device,
        greedy_segment=args.greedy_segment or None,
        beam_length_margin=(None if args.beam_length_margin < 0
                            else args.beam_length_margin))
    if args.sequential:
        server = HTTPServer((args.host, args.port),
                            make_handler(cap, cap.tc.id))
        mode = "sequential"
    else:
        front = MicroBatcher(cap, flush_ms=args.flush_ms,
                             max_queue=args.max_queue or None,
                             deadline_s=args.deadline_s or None)
        server = ThreadingHTTPServer((args.host, args.port),
                                     make_handler(front, cap.tc.id))
        mode = (f"micro-batched (flush {args.flush_ms}ms, "
                f"max_queue {args.max_queue or 'inf'}, "
                f"deadline {args.deadline_s or 'none'})")
    print(f"serving {cap.tc.id} on http://{args.host}:{args.port} "
          f"[{mode}, {args.device}]")
    server.serve_forever()


if __name__ == "__main__":
    main()
