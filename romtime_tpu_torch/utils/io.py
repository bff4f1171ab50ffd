"""Checkpoint and report IO (counterpart of ``romtime_tpu/utils/io.py``).

Pickle, JSON and npz as the reference writes them. CSV reports go through
the ``csv`` module (no pandas): :func:`dump_csv` writes the table that
``pandas.DataFrame(obj).to_csv(path)`` writes for a dict of columns.
"""

import csv
import json
import pickle

import numpy as np


def read_pickle(path):
    with open(path, mode="rb") as fp:
        return pickle.load(fp)


def dump_pickle(path, obj):
    with open(path, mode="wb") as fp:
        pickle.dump(obj, fp)


def dump_json(path, obj):
    with open(path, mode="w") as fp:
        json.dump(obj, fp, default=_json_default)


def read_json(path):
    with open(path, mode="r") as fp:
        return json.load(fp)


def write_table(path, columns, index, index_name=""):
    """Write ``columns`` (name → 1-D values) with ``index`` as the first
    column, headed ``index_name``, as ``DataFrame.to_csv`` lays it out:
    every cell is ``str`` of its value (a float's shortest repr in its
    own precision, as pandas writes it)."""
    with open(path, mode="w", newline="") as fp:
        writer = csv.writer(fp, lineterminator="\n")
        writer.writerow([index_name] + [str(k) for k in columns])
        for r, label in enumerate(index):
            writer.writerow([str(label)]
                            + [str(v[r]) for v in columns.values()])


def dump_csv(path, obj):
    """``pandas.DataFrame(obj).to_csv(path)`` for a dict of equal-length
    columns and scalars (a scalar fills its column), index 0..n-1."""
    lengths = {len(v) for v in obj.values() if np.ndim(v) > 0}
    n = lengths.pop() if lengths else 1
    if lengths:
        raise ValueError("dump_csv: columns of unequal length")
    columns = {k: (v if np.ndim(v) > 0 else [v] * n) for k, v in obj.items()}
    write_table(path, columns, range(n))


def dump_npz(path, **arrays):
    """Write named arrays to a compressed npz container."""
    np.savez_compressed(path, **arrays)


def read_npz(path):
    """Load an npz container as a dict of arrays."""
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}


def _json_default(obj):
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (np.integer,)):
        return int(obj)
    raise TypeError(f"Cannot serialize {type(obj)} to JSON.")
