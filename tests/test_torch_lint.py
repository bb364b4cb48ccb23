"""The repository's static analyzer (``tools/mxlint``) over the port's
tree: no active finding (trace purity, terminal outcomes, page
refcounts, host syncs, lock discipline), and every file parsed."""

import json
import os

from tools.mxlint import cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_tree_has_no_active_mxlint_finding(capsys):
    rc = cli.main([os.path.join(ROOT, "incubator_mxnet_tpu_torch"),
                   "--root", ROOT, "--json"])
    out, err = capsys.readouterr()
    findings = json.loads(out)
    active = [f for f in findings if f.get("status", "active") == "active"]
    assert rc == 0 and active == [], active
    assert " 0 active" in err and "files" in err
    n_files = int(err.split("mxlint:")[1].split("files")[0])
    py = sum(name.endswith(".py") for _, _, names in os.walk(
        os.path.join(ROOT, "incubator_mxnet_tpu_torch")) for name in names)
    assert n_files == py
