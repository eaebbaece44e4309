"""Serve the flagship binary ResNet-18 from a QAT checkpoint (counterpart of
``examples/serve.py``)::

    python -m bnn_tpu_torch.examples.serve --ckpt PATH      # restore + serve
    python -m bnn_tpu_torch.examples.serve                  # random weights
    python -m bnn_tpu_torch.examples.serve --continuous     # a request stream
    python -m bnn_tpu_torch.examples.serve --device cpu     # plain versions
    python -m bnn_tpu_torch.examples.serve --export PATH    # write a bundle
    python -m bnn_tpu_torch.examples.serve --load PATH      # serve a bundle

Inside ``Predictor``: deploy (packed / int8 binary layers, folded
epilogues), BN folds, the classifier head stored as int8
(``quantize_float_bits=8``), on the card the fused stem, stage and block
kernels, then bf16. ``--ckpt`` takes a directory written by
``bnn_tpu_torch.utils.save_checkpoint``. ``--continuous`` sends a Poisson
stream of single-image requests through ``ContinuousBatcher``, which joins
them into the predictor's batch. ``--export`` writes the frozen serving
bundle (``inference/export.py``: the traced program with its weights) and
exits; ``--load`` serves such a bundle without building a model, on the
device type it was exported on (pass the same ``--device``). Multi-device
serving (``--data-parallel`` / ``--tensor-parallel``) is not ported yet.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

import bnn_tpu_torch as bt
from bnn_tpu_torch.inference import ContinuousBatcher, Predictor, load_serving
from bnn_tpu_torch.ops import (BasicInputBinarizer, BasicScaleBinarizer,
                               XNORWeightBinarizer)


def build_model(num_classes: int) -> torch.nn.Module:
    """The CIFAR-10 example's config: binary body, float first and last
    layers, torch-parity ternary sign (a zero_to_one sign after a ReLU would
    be a constant +1)."""
    model = bt.models.resnet18(num_classes=num_classes,
                               generator=torch.Generator().manual_seed(0))
    return bt.prepare_binary_model(
        model,
        bt.BConfig(activation_pre_process=BasicInputBinarizer,
                   activation_post_process=BasicScaleBinarizer,
                   weight_pre_process=XNORWeightBinarizer),
        ignore_layers_name=["_first_", "_last_"])


def serve_stream(predictor, args, shape) -> None:
    """A Poisson stream of single-image requests through the continuous
    batcher, as many images as ``--requests`` full batches."""
    rng = np.random.default_rng(0)
    n = max(args.requests, 1) * args.batch_size
    predictor(np.zeros((1, *shape), np.float32)).cpu()  # first call, off the clock
    t0 = time.perf_counter()
    with ContinuousBatcher(predictor, max_delay_ms=5.0) as srv:
        futs = []
        for _ in range(n):
            futs.append(srv.submit(rng.standard_normal((1, *shape), np.float32)))
            time.sleep(float(rng.exponential(1.0 / args.stream_rps)))
        for f in futs:
            f.result(timeout=300)
        st = srv.stats()
    wall = time.perf_counter() - t0
    print(f"stream: {st.requests} requests ({st.rows} images) in {wall:.2f}s = "
          f"{st.rows / wall:.0f} img/s at {args.stream_rps:.0f} rps offered; "
          f"{st.batches} batches, occupancy {st.mean_occupancy * 100:.0f}%, "
          f"latency p50 {st.latency_percentile(50):.1f} ms / "
          f"p99 {st.latency_percentile(99):.1f} ms")


def serve_loop(predictor, args, shape=None) -> None:
    shape = tuple(shape) if shape is not None else (3, args.size, args.size)
    if args.continuous:
        serve_stream(predictor, args, shape)
        return
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        n = int(rng.integers(1, args.batch_size + 1))  # ragged request sizes
        x = rng.standard_normal((n, *shape), np.float32)
        t0 = time.perf_counter()
        logits = predictor(x)
        top1 = logits.argmax(-1).cpu()  # waits for the card
        print(f"request {i}: {n} images -> top-1 {top1.tolist()} "
              f"({(time.perf_counter() - t0) * 1e3:.1f} ms incl. host)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", default=None, help="QAT checkpoint directory")
    ap.add_argument("--num-classes", type=int, default=1000)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--export", default=None, metavar="PATH",
                    help="write a serving bundle (program + weights) and exit")
    ap.add_argument("--load", default=None, metavar="PATH",
                    help="serve from an exported bundle instead of building "
                         "a model")
    ap.add_argument("--continuous", action="store_true",
                    help="serve a single-image request stream through the "
                         "continuous batcher instead of batched requests")
    ap.add_argument("--stream-rps", type=float, default=200.0,
                    help="offered load for --continuous (requests/s, "
                         "Poisson arrivals)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the kernels) or 'cpu' (their plain versions)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if args.load:
        predictor = load_serving(args.load, device=device)
        print(f"loaded bundle {args.load}: platforms "
              f"{list(predictor.platforms)}, batch {predictor.batch_size}, "
              f"state {predictor.state_bytes() / 1e6:.2f} MB")
        args.batch_size = predictor.batch_size
        serve_loop(predictor, args, shape=predictor.input_shape)
        return
    on_card = device.type == "cuda"
    common = dict(batch_size=args.batch_size, fuse=on_card,
                  quantize_float_bits=8, device=device)
    if args.ckpt:
        predictor = Predictor.from_checkpoint(
            args.ckpt, lambda: build_model(args.num_classes), **common)
    else:
        predictor = Predictor(build_model(args.num_classes), **common)
    mode = (f"CUDA kernels on {torch.cuda.get_device_name(device)}" if on_card
            else "plain PyTorch versions on the CPU")
    print(f"serving state: {predictor.state_bytes() / 1e6:.2f} MB, "
          f"batch {args.batch_size}, {mode}")
    if args.export:
        predictor.export(args.export, input_shape=(3, args.size, args.size))
        print(f"exported serving bundle to {args.export} "
              f"(serve it with --load {args.export})")
        return
    serve_loop(predictor, args)


if __name__ == "__main__":
    main()
