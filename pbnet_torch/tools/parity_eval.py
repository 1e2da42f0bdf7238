"""One-command checkpoint-parity harness (port of tools/parity_eval.py).

The acceptance test of the system: the reference's published ScanNet v2 val
numbers (mAP / AP50 / AP25 = 56.4 / 71.4 / 80.3) from the reference's own
MinkowskiEngine ``.pth``.  It needs the real val scans and the real
checkpoint; with both at hand, one command runs the whole chain:

  python -m pbnet_torch.tools.parity_eval --pth pretrain/000000452.pth \\
      --scans /path/to/scans --data_root ./datasets/scannetv2

Steps:
  1. decode the raw val scans (``<scans>/val/*_vh_clean_2.ply``) into
     ``<data_root>/npy`` (skipped without ``--scans`` when that directory
     exists),
  2. write the val-split GT files ``<data_root>/val_gt/<scene>.txt`` if they
     are missing,
  3. build the test-variant config (``config.test_config``: cluster_epoch
     -1, batch 1, three TTA copies, NMS 0.10 / score 0.07 / npoints 101,
     superpoint refinement) with the flags' overrides,
  4. build the model on the device,
  5. convert the checkpoint (``tools/convert_checkpoint.py``, ME x-fastest
     kernel-offset order by default) and load it, logging the converted
     tensors that found no place in the model,
  6. evaluate the val split in test mode (``engine.evaluate``),
  7. print mAP / AP50 / AP25 beside the published numbers.

``--device``: CUDA unless ``--device cpu`` is passed; without a GPU the
command raises.  ``main`` returns the result dict.
"""

from __future__ import annotations

import argparse
import os

REFERENCE_NUMBERS = {"mAP": 56.4, "AP50": 71.4, "AP25": 80.3}


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pth", required=True, help="reference PBNet checkpoint (.pth)")
    ap.add_argument("--scans", default=None,
                    help="raw ScanNet dir with a val/ subdir of *_vh_clean_2.ply scans "
                         "(decode_scannet.split_scans layout); omit if <data_root>/npy is "
                         "already decoded")
    ap.add_argument("--data_root", default="./datasets/scannetv2")
    ap.add_argument("--label_map", default=None,
                    help="scannetv2-labels.combined.tsv (raw decode only)")
    ap.add_argument("--max_scenes", type=int, default=None)
    ap.add_argument("--me_order", default="x_fastest", choices=["x_fastest", "z_fastest"])
    # overrides for small-arch checkpoints
    ap.add_argument("--backbone_arch", default=None)
    ap.add_argument("--dunet_arch", default=None)
    ap.add_argument("--score_arch", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: cuda; 'cpu' for the plain path)")
    return ap


def run_parity(cfg, pth_path: str, me_order: str = "x_fastest", max_scenes=None,
               logger=None, device=None):
    """Decoded data ready -> convert the checkpoint -> evaluate: (result
    dict, names of the converted tensors that matched nothing, timing)."""
    from .. import engine, resolve_device
    from ..data.dataset import Dataset
    from . import convert_checkpoint as cc
    from . import log as log_tools

    logger = logger or log_tools.get_logger(cfg)
    dataset = Dataset(cfg)
    if not dataset.val_file_list:
        raise FileNotFoundError(f"no val scenes under {cfg.data_root} (scannetv2_val.txt)")
    model = engine.build_model(cfg, resolve_device(device))
    converted = cc.load_reference_checkpoint(pth_path, me_order)
    unmatched = cc.merge_into_model(model, converted)
    logger.info(f"converted {pth_path}: {sum(t.numel() for t in converted.values())} weights")
    if unmatched:
        logger.warning(
            f"{len(unmatched)} converted tensors did not land on the model "
            f"(arch mismatch?): {unmatched[:8]}{'...' if len(unmatched) > 8 else ''}")
    timing = {}
    res = engine.evaluate(cfg, model, dataset, epoch=cfg.epochs, logger=logger,
                          max_scenes=max_scenes, test_mode=True, timing=timing)
    return res, unmatched, timing


def main(argv=None, cfg=None):
    """``cfg`` replaces the test-variant config built from the flags (tiny
    shapes and UNets in the tests)."""
    args = build_argparser().parse_args(argv)

    from .. import resolve_device
    from ..config import test_config
    from ..data import decode_scannet as dec

    device = resolve_device(args.device)
    if cfg is None:
        cfg = test_config().replace(data_root=args.data_root, cache=False)
        for k in ("backbone_arch", "dunet_arch", "score_arch"):
            if getattr(args, k):
                cfg = cfg.replace(**{k: getattr(args, k)})

    npy_dir = os.path.join(cfg.data_root, "npy")
    if args.scans:
        print(f"decoding val scans from {args.scans} -> {npy_dir}")
        dec.decode_split(args.scans, "val", npy_dir, args.label_map)
    if not os.path.isdir(npy_dir):
        raise SystemExit(f"{npy_dir} missing — pass --scans to decode raw ScanNet data")
    gt_dir = os.path.join(cfg.data_root, "val_gt")
    if not os.path.isdir(gt_dir):
        with open(os.path.join(cfg.data_root, "scannetv2_val.txt")) as f:
            val_list = [ln.strip() for ln in f if ln.strip()]
        dec.write_val_gt(npy_dir, val_list, gt_dir)

    res, unmatched, timing = run_parity(cfg, args.pth, args.me_order, args.max_scenes,
                                        device=device)
    print("\n=== parity vs reference (published ScanNet v2 val, newest checkpoint) ===")
    for k, ref in REFERENCE_NUMBERS.items():
        ours = res.get(k)
        ours_s = f"{100 * ours:.1f}" if ours is not None else "n/a"
        print(f"{k:5s}: ours {ours_s}  reference {ref}")
    print(f"mIoU : ours {100 * res['mIoU']:.1f}")
    if timing.get("scenes_per_sec_warm"):
        print(f"throughput: {timing['scenes_per_sec_warm']} scenes/s (warm)")
    return res


if __name__ == "__main__":
    main()
