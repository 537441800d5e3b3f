"""Frame retrieval AP@K.

Counterpart of `video_rep_learning_tpu/evaluation/retrieval.py`, the same
math line for line: per query video, the other videos' strided frames are the
candidates; AP = mean over query frames of the share of the top-K candidates
with the query frame's phase label. Returns AP@K_list[0].
"""

from __future__ import annotations

import numpy as np
from scipy.spatial.distance import cdist

from ..data.splits import DATASET_TO_NUM_CLASSES
from ..logging_utils import get_logger

logger = get_logger(__name__)


class Retrieval:
    def __init__(self, cfg):
        self.cfg = cfg
        self.downstream_task = True
        self.K_list = cfg.EVAL.RETRIEVAL_KS
        self.dist_type = cfg.EVAL.KENDALLS_TAU_DISTANCE
        self.stride = cfg.EVAL.KENDALLS_TAU_STRIDE

    def evaluate(self, dataset, cur_epoch, summary_writer):
        self.num_classes = DATASET_TO_NUM_CLASSES.get(dataset["name"])
        val_embs = dataset["val_dataset"]["embs"]
        val_labels = dataset["val_dataset"]["labels"]
        val_APs = [self.get_AP(val_embs, val_labels, K, cur_epoch,
                               summary_writer, "%s_val" % dataset["name"])
                   for K in self.K_list]
        return val_APs[0]

    def get_AP(self, embs_list, label_list, K, cur_epoch, summary_writer,
               split, visualize=False):
        num_seqs = len(embs_list)
        precisions = np.zeros(num_seqs)
        for i in range(num_seqs):
            query_feats = embs_list[i][::self.stride]
            query_label = label_list[i][::self.stride]
            candidate_feats = np.concatenate(
                [embs_list[j][::self.stride] for j in range(num_seqs) if j != i],
                axis=0)
            candidate_label = np.concatenate(
                [label_list[j][::self.stride] for j in range(num_seqs) if j != i],
                axis=0)
            dists = cdist(query_feats, candidate_feats, self.dist_type)
            topk = np.argsort(dists, axis=1)[:, :K]
            ap = 0.0
            for t in range(len(query_feats)):
                ap += np.mean(int(query_label[t]) == candidate_label[topk[t]])
            precisions[i] = ap / len(query_feats)
        precisions = precisions[~np.isnan(precisions)]
        precision = float(np.mean(precisions)) if len(precisions) else float("nan")
        logger.info("epoch[%d/%d] %s set AP@%d precision: %.2f%%",
                    cur_epoch, self.cfg.TRAIN.MAX_EPOCHS, split, K,
                    100 * precision)
        if summary_writer is not None:
            summary_writer.add_scalar(
                f"AP/{split} set {K}_align_precision", precision, cur_epoch)
        return precision
