"""The repo's static checks over the port: the lint suite finds nothing in
``trino_tpu_torch/``, and every ``TRINO_TPU_*`` name that appears in its
sources is declared in ``trino_tpu_torch.knobs.ENV_KNOBS``."""

import os
import re

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_lint_trino_tpu_torch_clean():
    from tools.lint.engine import run_lint

    result = run_lint(subdir="trino_tpu_torch")
    assert not [f"{f.file}:{f.line} [{f.rule}] {f.message}" for f in result.findings]


def test_every_port_env_var_is_declared():
    from trino_tpu_torch import knobs

    declared = {k.name for k in knobs.ENV_KNOBS}
    pat = re.compile(r"TRINO_TPU_[A-Z_]+")
    undeclared = {}
    for dirpath, _dirs, files in os.walk(os.path.join(REPO, "trino_tpu_torch")):
        for fname in files:
            if fname.endswith(".py"):
                path = os.path.join(dirpath, fname)
                with open(path) as f:
                    for name in pat.findall(f.read()):
                        if name not in declared:
                            undeclared.setdefault(name, path)
    assert not undeclared, undeclared
