"""Faults planted under the timed path, for the tests that see ``correct``
come out false."""

from __future__ import annotations

import torch


class Fault:
    """No fault: the batch, the outputs and the update as they are."""

    skip_update = False
    no_exchange = False

    def batch(self, batch: dict) -> dict:
        return batch

    def outputs(self, out: dict) -> dict:
        return out


class HalfBatchLeftOut(Fault):
    """Half of each request's points (eval) or of each batch's rooms
    (train) left out; what is computed is over the rest."""

    def batch(self, batch):
        b = dict(batch)
        if "sem_label" in b:  # a training batch of rooms
            keep = (int(b["point_batch"][b["point_valid"]].max()) + 1) // 2
            b["point_valid"] = b["point_valid"] & (b["point_batch"] < keep)
            b["vox_valid"] = b["vox_valid"] & (b["vox_coords"][:, 0] < keep)
        else:
            n = int(b["point_valid"].sum())
            b["point_valid"] = b["point_valid"] & (torch.arange(
                b["point_valid"].shape[0], device=b["point_valid"].device) < n // 2)
        return b


class ClusterIdAltered(Fault):
    """One point's cluster answer changed where clustering produced it."""

    def outputs(self, out):
        cid = out["cluster_id"].clone()
        j = int(torch.nonzero(cid >= 0)[0, 0])
        cid[j] = cid[j] + 1
        return dict(out, cluster_id=cid)


class LogitsAltered(Fault):
    """Stage 1's semantic logits scaled by 1.5 where the backbone produced
    them."""

    def outputs(self, out):
        return dict(out, logits=out["logits"] * 1.5)


class StateUnchanged(Fault):
    """A train step that leaves the parameters and the optimizer as they
    were."""

    skip_update = True


class ExchangeLeftOut(Fault):
    """Data-parallel ranks that neither average their gradients nor share
    their norms' statistics."""

    no_exchange = True
