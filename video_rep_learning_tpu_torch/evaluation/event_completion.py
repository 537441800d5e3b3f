"""Event-completion (phase progression) regression.

Counterpart of `video_rep_learning_tpu/evaluation/event_completion.py`, the
same math line for line: per phase class a signed normalised
distance-to-last-transition target, one least-squares fit with intercept
per output (sklearn's LinearRegression there, the port's
`linear_models.LeastSquares` here, in numpy and scipy), score = mean R^2.
"""

from __future__ import annotations

import numpy as np

from ..data.splits import DATASET_TO_NUM_CLASSES
from ..logging_utils import get_logger
from .linear_models import LeastSquares

logger = get_logger(__name__)


def regression_labels_for_class(labels, class_idx):
    # last occurrence of the class == the phase transition frame
    transition_frame = np.argwhere(labels == class_idx)[-1, 0]
    return (np.arange(float(len(labels))) - transition_frame) / len(labels)


def get_regression_labels(class_labels, num_classes):
    return np.stack([regression_labels_for_class(class_labels, i)
                     for i in range(num_classes - 1)], axis=1)


def get_targets_from_labels(all_class_labels, num_classes):
    return [get_regression_labels(cl, num_classes) for cl in all_class_labels]


def fit_model(train_embs, train_labels, val_embs, val_labels):
    train_embs = np.concatenate(train_embs, axis=0)
    train_labels = np.concatenate(train_labels, axis=0)
    val_embs = np.concatenate(val_embs, axis=0)
    val_labels = np.concatenate(val_labels, axis=0)
    lin_model = LeastSquares().fit(train_embs, train_labels)
    return (lin_model, lin_model.score(train_embs, train_labels),
            lin_model.score(val_embs, val_labels))


class EventCompletion:
    def __init__(self, cfg):
        self.cfg = cfg
        self.downstream_task = True

    def evaluate(self, dataset, cur_epoch, summary_writer, visualize=True):
        fractions = self.cfg.EVAL.CLASSIFICATION_FRACTIONS
        num_classes = DATASET_TO_NUM_CLASSES.get(dataset["name"], 2)
        train = dataset["train_dataset"]
        if len(train["embs"]) == 0 or len(dataset["val_dataset"]["embs"]) == 0:
            raise ValueError("All embeddings are NAN. Something is wrong with model.")
        val_labels = get_targets_from_labels(dataset["val_dataset"]["labels"],
                                             num_classes)
        num_samples = len(train["embs"])
        val_scores = []
        for fraction in fractions:
            num_used = max(1, int(fraction * num_samples))
            train_embs = train["embs"][:num_used]
            train_labels = get_targets_from_labels(train["labels"][:num_used],
                                                   num_classes)
            _, train_score, val_score = fit_model(
                train_embs, train_labels, dataset["val_dataset"]["embs"],
                val_labels)
            prefix = "%s_%s" % (dataset["name"], str(fraction))
            logger.info("[Global step: %d] Event Completion %s Fraction Train "
                        "Score: %.3f,", cur_epoch, prefix, train_score)
            logger.info("[Global step: %d] Event Completion %s Fraction Val "
                        "Score: %.3f,", cur_epoch, prefix, val_score)
            if summary_writer is not None:
                summary_writer.add_scalar(
                    f"event_completion/train_{prefix}_score", train_score, cur_epoch)
                summary_writer.add_scalar(
                    f"event_completion/val_{prefix}_score", val_score, cur_epoch)
            val_scores.append(val_score)
        return val_scores[-1]
