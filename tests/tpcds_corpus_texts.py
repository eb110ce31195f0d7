"""The SQL texts of the TPC-DS corpus in ``tests/test_tpcds.py``, read from
that file as text: the first ``runner.execute(\"\"\"...\"\"\")`` of each
``test_q*``. Plain Python (no JAX, no pandas), so the on-card smoke run can
use it too; no copy of the texts is kept, so none can drift."""

import os
import re

CORPUS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "test_tpcds.py")
N_QUERIES = 25

_TEST = re.compile(r"\n    def (test_q\w+)\(.*?\):\n(.*?)(?=\n    def |\nclass |\Z)", re.S)
_EXECUTE = re.compile(r'runner\.execute\("""(.*?)"""', re.S)


def tpcds_corpus(path: str = CORPUS_FILE) -> dict:
    """{name: sql} in file order, the name without its ``test_`` prefix
    (``q3``, ``q27_rollup``). Raises unless exactly 25 come out."""
    with open(path) as f:
        src = f.read()
    out = {}
    for m in _TEST.finditer(src):
        q = _EXECUTE.search(m.group(2))
        if q is not None:
            out[m.group(1)[len("test_"):]] = q.group(1).strip()
    if len(out) != N_QUERIES:
        raise RuntimeError(
            f"{path}: {len(out)} TPC-DS corpus queries found, expected {N_QUERIES}"
        )
    return out
