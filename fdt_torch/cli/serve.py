"""HTTP detection server: micro-batched serving of any detector family on the
card (counterpart of scripts/serve.py, with the same flags).

  python -m fdt_torch.cli.serve --detector pyramid --net repo \
      --weights net_weight/repo_mini.npz --port 8000
  curl -s -X POST --data-binary @face.png localhost:8000/detect
  curl -s localhost:8000/healthz

Weights are variables npz files in fdt's format or reference .pth/.pt
state dicts.  `--quant int8` serves the pyramid or FaceBoxes family with int8
convolutions (kernels K5 and K4 on the card) and is refused for the mtcnn
cascade, as in fdt.  `--dp_devices n` shards each micro-batch over n
devices (the pyramid and FaceBoxes families, as in fdt): the first n cards,
or n slots on the CPU with --device cpu (fdt_torch.dist.make_mesh).
"""
from __future__ import annotations

import argparse

from fdt_torch.cli._common import add_device_flag


def build_service(args):
    from fdt_torch.apps.serving import DetectionService
    kw = dict(threshold=args.threshold, max_batch=args.max_batch,
              max_wait_ms=args.max_wait_ms,
              frame_size=(args.frame_w, args.frame_h))
    mesh = None
    if args.dp_devices:  # shard each coalesced batch over the mesh
        if args.detector == "mtcnn":
            raise SystemExit("--dp_devices is not wired for the mtcnn cascade")
        from fdt_torch.dist import make_mesh
        try:
            mesh = (make_mesh(devices=["cpu"] * args.dp_devices) if args.device == "cpu"
                    else make_mesh(args.dp_devices))
        except ValueError as e:
            raise SystemExit(f"--dp_devices {args.dp_devices}: {e}") from None
    if args.detector == "pyramid":
        from fdt_torch.models.loader import load_pyramidbox_detector
        det = load_pyramidbox_detector(args.net, args.weights, budget=5000,
                                       device=None if mesh else args.device,
                                       quant=args.quant, mesh=mesh)
        return DetectionService("pyramidbox", det, **kw)
    if not args.weights:
        raise SystemExit(f"--weights is required for --detector {args.detector}")
    if args.detector == "facebox":
        from fdt_torch.models.loader import load_facebox_detector
        return DetectionService("facebox", load_facebox_detector(
            args.weights, device=None if mesh else args.device, quant=args.quant,
            mesh=mesh), **kw)
    if args.quant:
        raise SystemExit("--quant is not supported for the mtcnn cascade")
    paths = args.weights.split(",")  # pnet,rnet,onet: npz or .pt files
    if len(paths) != 3:
        raise SystemExit("--weights for mtcnn must be 'pnet.npz,rnet.npz,"
                         f"onet.npz' (got {len(paths)} paths)")
    from fdt_torch.infer.mtcnn_device import FAST_BUDGETS, MID_BUDGETS
    from fdt_torch.models.loader import load_mtcnn_cascade
    # budget ladder: typical scenes run the small tiers, crowded frames
    # escalate; the keep sets are the same either way
    det = load_mtcnn_cascade(*paths, fast_budgets=(FAST_BUDGETS, MID_BUDGETS),
                             device=args.device)
    return DetectionService("mtcnn", det, **kw)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--detector", default="pyramid",
                    choices=["pyramid", "facebox", "mtcnn"])
    ap.add_argument("--net", default="repo", help="pyramid variant")
    ap.add_argument("--weights", default=None,
                    help="variables npz or torch .pth/.pt; for --detector mtcnn: "
                         "'pnet.npz,rnet.npz,onet.npz'")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--frame_w", type=int, default=640)
    ap.add_argument("--frame_h", type=int, default=480)
    ap.add_argument("--threshold", type=float, default=0.4)
    ap.add_argument("--max_batch", type=int, default=32)
    ap.add_argument("--max_wait_ms", type=float, default=5.0)
    ap.add_argument("--quant", default=None, choices=[None, "int8"],
                    help="int8 inference (pyramid and facebox)")
    ap.add_argument("--dp_devices", default=0, type=int,
                    help="data-parallel serving (pyramid/facebox): shard each "
                         "micro-batch over an n-device mesh")
    ap.add_argument("--no_warmup", action="store_true",
                    help="skip building the kernels and the warm-up batches")
    add_device_flag(ap)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    from fdt_torch.apps.serving import serve_http
    service = build_service(args)
    if not args.no_warmup:
        print("warming up (kernel build, every batch size to max_batch)...", flush=True)
        service.warmup()
    serve_http(service, args.host, args.port)


if __name__ == "__main__":
    main()
