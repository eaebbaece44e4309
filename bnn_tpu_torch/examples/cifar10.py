"""CIFAR-10 QAT training (counterpart of ``examples/cifar10.py``)::

    python -m bnn_tpu_torch.examples.cifar10 --synthetic --epochs 2
    python -m bnn_tpu_torch.examples.cifar10 --resume ./checkpoint/cifar10 --epochs 3
    python -m bnn_tpu_torch.examples.cifar10 --device cpu ...   # plain PyTorch on the CPU

Trains a binarized ResNet-18 with the reference's configuration: sign
inputs, XNOR weights, no output scale, the first and last layers kept
full-precision by empty per-layer BConfigs; Adam at ``--lr``, cross entropy,
best-accuracy checkpointing. Each batch is augmented (reflect-padded random
crop, horizontal flip) and normalised on the host, then moved to the card in
NCHW; the training arithmetic runs on the card.

Data: CIFAR-10 from a local ``cifar-10-batches-py`` directory
(``--data-dir``, torchvision's on-disk format), else a synthetic stand-in of
2,048 training and 512 test images, so the loop runs anywhere.
"""
from __future__ import annotations

import argparse
import os
import pickle
import time

import numpy as np
import torch

import bnn_tpu_torch as bt
from bnn_tpu_torch.data import augment_crop_flip
from bnn_tpu_torch.ops import BasicInputBinarizer, Identity, XNORWeightBinarizer
from bnn_tpu_torch.parallel import make_eval_step, make_train_step
from bnn_tpu_torch.utils import (AverageMeter, ProgressMeter, count_parameters,
                                 load_checkpoint, restore_into,
                                 restore_optimizer, save_checkpoint)

CIFAR_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR_STD = np.array([0.2023, 0.1994, 0.2010], np.float32)


def load_cifar10(data_dir):
    """Read the standard cifar-10-batches-py pickles into NHWC arrays in
    [0, 1]. The pickles are the dataset's own files: open only a directory
    you trust."""
    def _batch(name):
        with open(os.path.join(data_dir, name), "rb") as fh:
            d = pickle.load(fh, encoding="bytes")
        x = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return x.astype(np.float32) / 255.0, np.array(d[b"labels"], np.int32)

    xs, ys = zip(*[_batch(f"data_batch_{i}") for i in range(1, 6)])
    x_train, y_train = np.concatenate(xs), np.concatenate(ys)
    x_test, y_test = _batch("test_batch")
    return (x_train, y_train), (x_test, y_test)


def synthetic_cifar10(n_train=2048, n_test=512, seed=0):
    rng = np.random.default_rng(seed)
    x_train = rng.normal(0.5, 0.25, (n_train, 32, 32, 3)).astype(np.float32)
    y_train = rng.integers(0, 10, n_train).astype(np.int32)
    x_test = rng.normal(0.5, 0.25, (n_test, 32, 32, 3)).astype(np.float32)
    y_test = rng.integers(0, 10, n_test).astype(np.int32)
    return (x_train, y_train), (x_test, y_test)


def normalize(x):
    return (x - CIFAR_MEAN) / CIFAR_STD


def augment(x, rng):
    """Random crop (pad 4) + horizontal flip, the reference's transforms,
    vectorised."""
    return augment_crop_flip(x, rng, pad=4)


def build_model(seed: int = 0) -> torch.nn.Module:
    """Binary ResNet-18 for 10 classes; ``conv1`` and ``fc`` float through
    empty (all-Identity) BConfigs, the reference's CIFAR convention."""
    model = bt.models.resnet18(num_classes=10,
                               generator=torch.Generator().manual_seed(seed))
    return bt.prepare_binary_model(
        model,
        bt.BConfig(activation_pre_process=BasicInputBinarizer,
                   activation_post_process=Identity,
                   weight_pre_process=XNORWeightBinarizer),
        custom_config_layers_name={"conv1": bt.BConfig(), "fc": bt.BConfig()})


def to_device(x: np.ndarray, y: np.ndarray, device: torch.device):
    """An NHWC float batch and its labels as NCHW float32 and int64 on
    ``device``."""
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    return xt.to(device), torch.from_numpy(y).long().to(device)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="bnn_tpu_torch CIFAR-10 training")
    parser.add_argument("--data-dir", default=None,
                        help="path to cifar-10-batches-py")
    parser.add_argument("--synthetic", action="store_true",
                        help="force synthetic data")
    parser.add_argument("--epochs", type=int, default=200)
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--resume", default=None)
    parser.add_argument("--out", default="./checkpoint/cifar10")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the card) or 'cpu' (plain PyTorch)")
    args = parser.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the trainer runs on CUDA by default and no CUDA "
                           "device is available; pass --device cpu")
    if args.data_dir and not args.synthetic:
        (x_train, y_train), (x_test, y_test) = load_cifar10(args.data_dir)
    else:
        print("==> Using synthetic CIFAR-10 stand-in data")
        (x_train, y_train), (x_test, y_test) = synthetic_cifar10()

    print("==> Building model..")
    model = build_model(args.seed).to(device)
    print(f"==> {count_parameters(model):,} trainable parameters")

    optimizer = torch.optim.Adam(model.parameters(), lr=args.lr)
    train_step = make_train_step()
    eval_step = make_eval_step()

    start_epoch, best_acc = 0, 0.0
    if args.resume:
        payload = load_checkpoint(args.resume)
        restore_into(model, payload)
        # Adam's moments and step counts too: resuming with reset moments
        # departs from an uninterrupted run (a loss spike)
        if payload.get("opt_state") is not None:
            restore_optimizer(optimizer, payload)
        meta = payload.get("metadata", {})
        start_epoch = int(meta.get("epoch", 0))
        best_acc = float(meta.get("best_acc", 0.0))
        print(f"==> Resumed from {args.resume} at epoch {start_epoch}")

    rng = np.random.default_rng(args.seed)
    n_train = x_train.shape[0]
    for epoch in range(start_epoch, args.epochs):
        # train
        model.train()
        perm = rng.permutation(n_train)
        losses = AverageMeter("Loss", ":.4e")
        top1 = AverageMeter("Acc@1", ":6.2f")
        batch_time = AverageMeter("Time", ":6.3f")
        nb = n_train // args.batch_size
        progress = ProgressMeter(nb, [batch_time, losses, top1],
                                 prefix=f"Epoch[{epoch}]")
        start = end = time.time()
        for b in range(nb):
            idx = perm[b * args.batch_size:(b + 1) * args.batch_size]
            xb = normalize(augment(x_train[idx], rng))
            metrics = train_step(model, optimizer,
                                 *to_device(xb, y_train[idx], device))
            losses.update(float(metrics["loss"]), len(idx))
            top1.update(float(metrics["top1"]) * 100.0, len(idx))
            batch_time.update(time.time() - end)
            end = time.time()
            if b % 50 == 0:
                progress.display(b)
        seconds = time.time() - start
        print(f"Epoch {epoch}: trained {nb * args.batch_size} images in "
              f"{seconds:.3f} s ({nb * args.batch_size / seconds:.1f} images/s)")

        # evaluate
        model.eval()
        tot = {"loss": 0.0, "top1": 0.0, "count": 0.0}
        for b in range(0, len(x_test), args.batch_size):
            xb = normalize(x_test[b:b + args.batch_size])
            m = eval_step(model, *to_device(xb, y_test[b:b + args.batch_size],
                                            device))
            for k in tot:
                tot[k] += float(m[k])
        acc = 100.0 * tot["top1"] / tot["count"]
        print(f"Epoch {epoch}: test acc {acc:.2f}% "
              f"(loss {tot['loss']/tot['count']:.4f})")

        # strict '>' (the reference's convention): a tie does not overwrite
        # the earlier best checkpoint
        is_best = acc > best_acc
        best_acc = max(best_acc, acc)
        save_checkpoint(args.out, model, opt_state=optimizer,
                        metadata={"epoch": epoch + 1, "best_acc": best_acc},
                        is_best=is_best)
    print(f"Best accuracy: {best_acc:.2f}%")


if __name__ == "__main__":
    main()
