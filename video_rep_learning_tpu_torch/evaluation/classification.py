"""Phase-classification linear probe.

Counterpart of `video_rep_learning_tpu/evaluation/classification.py`, the
same math line for line: an L2 logistic regression (lbfgs, C = 1) on frame
embeddings over train-video fractions; returns the val accuracy at the last
fraction. The default linear probe is the port's own
(`linear_models.LogisticRegression`, sklearn's estimator in numpy and
scipy), so the task runs where sklearn is absent; only the `svm` probe, never
the default, imports sklearn, where it is used.
"""

from __future__ import annotations

import numpy as np

from ..logging_utils import get_logger
from .linear_models import LogisticRegression

logger = get_logger(__name__)


def fit_linear_model(train_embs, train_labels, val_embs, val_labels):
    lin_model = LogisticRegression(max_iter=100000).fit(train_embs, train_labels)
    return (lin_model, lin_model.score(train_embs, train_labels),
            lin_model.score(val_embs, val_labels))


def fit_svm_model(train_embs, train_labels, val_embs, val_labels):
    from sklearn.svm import SVC

    svm_model = SVC(decision_function_shape="ovo", verbose=0)
    svm_model.fit(train_embs, train_labels)
    return (svm_model, svm_model.score(train_embs, train_labels),
            svm_model.score(val_embs, val_labels))


def fit_linear_models(train_embs, train_labels, val_embs, val_labels,
                      model_type="linear"):
    if model_type == "linear":
        return fit_linear_model(train_embs, train_labels, val_embs, val_labels)
    if model_type == "svm":
        return fit_svm_model(train_embs, train_labels, val_embs, val_labels)
    raise ValueError(f"{model_type} model type not supported")


class Classification:
    def __init__(self, cfg):
        self.cfg = cfg
        self.downstream_task = True

    def evaluate(self, dataset, cur_epoch, summary_writer, visualize=True):
        fractions = self.cfg.EVAL.CLASSIFICATION_FRACTIONS
        train_dataset = dataset["train_dataset"]
        val_embs = np.concatenate(dataset["val_dataset"]["embs"])
        if len(np.concatenate(train_dataset["embs"])) == 0 or len(val_embs) == 0:
            raise ValueError("All embeddings are NAN. Something is wrong with model.")
        val_labels = np.concatenate(dataset["val_dataset"]["labels"])

        num_samples = len(train_dataset["embs"])
        val_accs = []
        for fraction in fractions:
            num_used = max(1, int(fraction * num_samples))
            train_embs = np.concatenate(train_dataset["embs"][:num_used])
            train_labels = np.concatenate(train_dataset["labels"][:num_used])
            _, train_acc, val_acc = fit_linear_models(
                train_embs, train_labels, val_embs, val_labels)
            prefix = "%s_%s" % (dataset["name"], str(fraction))
            logger.info("[Epoch: %d] Classification %s Fraction "
                        "Train Accuracy: %.3f,", cur_epoch, prefix, train_acc)
            logger.info("[Epoch: %d] Classification %s Fraction "
                        "Val Accuracy: %.3f,", cur_epoch, prefix, val_acc)
            if summary_writer is not None:
                summary_writer.add_scalar(
                    f"classification/train_{prefix}_accuracy", train_acc, cur_epoch)
                summary_writer.add_scalar(
                    f"classification/val_{prefix}_accuracy", val_acc, cur_epoch)
            val_accs.append(val_acc)
        return val_accs[-1]
