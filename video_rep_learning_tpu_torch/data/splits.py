"""Dataset split sizes and per-dataset phase-class counts (the port's own
copy of `video_rep_learning_tpu/data/splits.py`).

Workload metadata matching the reference (`datasets/dataset_splits.py:18-51`):
Pouring (70/14/32 videos, 5 phases) and the 13 PennAction actions with their
2-6 phase classes. These constants parameterize the evaluation tasks
(retrieval/event-completion need the class count) and sanity checks on loaded
pickle indexes.
"""

DATASETS = {
    "pouring": {"train": 70, "val": 14, "test": 32},
    "baseball_pitch": {"train": 103, "val": 63},
    "baseball_swing": {"train": 113, "val": 57},
    "bench_press": {"train": 69, "val": 71},
    "bowl": {"train": 134, "val": 85},
    "clean_and_jerk": {"train": 40, "val": 42},
    "golf_swing": {"train": 87, "val": 77},
    "jumping_jacks": {"train": 56, "val": 56},
    "pushup": {"train": 102, "val": 106},
    "pullup": {"train": 98, "val": 101},
    "situp": {"train": 50, "val": 50},
    "squat": {"train": 111, "val": 115},
    "tennis_forehand": {"train": 79, "val": 74},
    "tennis_serve": {"train": 98, "val": 69},
}

DATASET_TO_NUM_CLASSES = {
    "pouring": 5,
    "baseball_pitch": 4,
    "baseball_swing": 3,
    "bench_press": 2,
    "bowl": 3,
    "clean_and_jerk": 6,
    "golf_swing": 3,
    "jumping_jacks": 4,
    "pushup": 2,
    "pullup": 2,
    "situp": 2,
    "squat": 4,
    "tennis_forehand": 3,
    "tennis_serve": 4,
}

PENN_ACTION_LIST = [
    "baseball_pitch", "baseball_swing", "bench_press", "bowl",
    "clean_and_jerk", "golf_swing", "jumping_jacks", "pushup", "pullup",
    "situp", "squat", "tennis_forehand", "tennis_serve",
]
