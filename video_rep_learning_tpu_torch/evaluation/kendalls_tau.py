"""Kendall's Tau alignment metric.

Counterpart of `video_rep_learning_tpu/evaluation/kendalls_tau.py`, the same
math line for line (this package cannot import the JAX package's evaluation
modules without JAX): for every ordered pair of val videos, stride the
embeddings, match nearest neighbours by cdist and correlate the indices
against arange; NaN-filtered mean.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial.distance import cdist
from scipy.stats import kendalltau

from ..logging_utils import get_logger

logger = get_logger(__name__)


def softmax(w, t=1.0):
    e = np.exp(np.array(w) / t)
    return e / np.sum(e)


class KendallsTau:
    def __init__(self, cfg):
        self.cfg = cfg
        self.downstream_task = True
        self.stride = cfg.EVAL.KENDALLS_TAU_STRIDE
        self.dist_type = cfg.EVAL.KENDALLS_TAU_DISTANCE
        self.temperature = 0.1 if cfg.MODEL.L2_NORMALIZE else 1.0

    def evaluate(self, dataset, cur_epoch, summary_writer):
        train_embs = dataset["train_dataset"]["embs"]
        self.get_kendalls_tau(train_embs, cur_epoch, summary_writer,
                              "%s_train" % dataset["name"], visualize=True)
        val_embs = dataset["val_dataset"]["embs"]
        return self.get_kendalls_tau(val_embs, cur_epoch, summary_writer,
                                     "%s_val" % dataset["name"], visualize=True)

    def get_kendalls_tau(self, embs_list, cur_epoch, summary_writer, split,
                         visualize=False):
        num_seqs = len(embs_list)
        taus = np.zeros(num_seqs * (num_seqs - 1))
        idx = 0
        for i in range(num_seqs):
            query_feats = embs_list[i][::self.stride]
            for j in range(num_seqs):
                if i == j:
                    continue
                candidate_feats = embs_list[j][::self.stride]
                dists = cdist(query_feats, candidate_feats, self.dist_type)
                nns = np.argmin(dists, axis=1)
                if visualize and summary_writer is not None:
                    if (i == 0 and j == 1) or (i < j and num_seqs == 14):
                        sim_matrix = np.array(
                            [softmax(-dists[k], t=self.temperature)
                             for k in range(len(query_feats))], np.float32)
                        summary_writer.add_image(
                            f"{split}/sim_matrix_{i}_{j}", sim_matrix.T,
                            cur_epoch, dataformats="HW")
                taus[idx] = kendalltau(np.arange(len(nns)), nns).correlation
                idx += 1
        taus = taus[~np.isnan(taus)]
        tau = float(np.mean(taus)) if len(taus) else float("nan")
        logger.info("epoch[%d/%d] %s set alignment tau: %.4f",
                    cur_epoch, self.cfg.TRAIN.MAX_EPOCHS, split, tau)
        if summary_writer is not None:
            summary_writer.add_scalar(f"kendalls_tau/{split}_align_tau", tau,
                                      cur_epoch)
        return tau
