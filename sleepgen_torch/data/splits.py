"""Subject-level train / valid / test splits, with the ``csv`` module.

The port's own copy of ``sleepgen/data/splits.py`` (the reference's
``src/preprocessing/split_train_valid_test_sleep_edfx.py``): 80/20, then
75/25 of the rest, of the unique subjects, as sklearn's
``train_test_split(shuffle=True, random_state=42)`` does it, so 60/20/20
by subject and no subject in two splits. Rows are dicts of the CSV's
strings in file order; ``write_splits`` writes the same CSV text as the
JAX package's pandas ``to_csv`` for integer and string id columns.
"""
from __future__ import annotations

import csv
from typing import Dict, List, Sequence, Tuple

import numpy as np

Rows = List[Dict[str, str]]


def _sk_split(values: np.ndarray, test_size: float, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """sklearn's train_test_split(shuffle=True): n_test = ceil(n test_size)
    from the head of RandomState(seed).permutation -> (train, test)."""
    n_test = int(np.ceil(len(values) * test_size))
    perm = np.random.RandomState(seed).permutation(len(values))
    return values[perm[n_test:]], values[perm[:n_test]]


def _unique_in_order(values: Sequence) -> np.ndarray:
    """The distinct values in order of first appearance (pandas' unique)."""
    return np.array(list(dict.fromkeys(values)), dtype=object)


def _key(value: str):
    """A subject id as pandas reads it: an int where the text is one."""
    try:
        return int(value)
    except ValueError:
        return value


def split_subjects(rows: Rows, subject_col: str = "subject",
                   seed: int = 42) -> Tuple[Rows, Rows, Rows]:
    """(train, valid, test) rows of ``rows``, split by subject."""
    subjects = _unique_in_order([_key(r[subject_col]) for r in rows])
    train, test = _sk_split(subjects, 0.2, seed)
    train, valid = _sk_split(train, 0.25, seed)

    def select(keep):
        keep = set(keep.tolist())
        return [r for r in rows if _key(r[subject_col]) in keep]

    return select(train), select(valid), select(test)


def write_splits(ids_csv: str, out_prefix: str | None = None) -> None:
    """``<prefix>_train.csv``, ``_valid.csv`` and ``_test.csv`` of
    ``ids_csv``'s rows (prefix: the file's name less ``.csv``)."""
    with open(ids_csv, newline="") as fh:
        reader = csv.DictReader(fh)
        rows = list(reader)
    base = out_prefix or ids_csv.replace(".csv", "")
    for name, part in zip(("train", "valid", "test"), split_subjects(rows)):
        with open(f"{base}_{name}.csv", "w", newline="") as fh:
            writer = csv.DictWriter(fh, fieldnames=reader.fieldnames, lineterminator="\n")
            writer.writeheader()
            writer.writerows(part)
