"""A module-scoped autouse fixture that removes, when a test module ends,
the temporary directories its tests and fixtures made (``tmp_path``,
``tmp_path_factory.mktemp``). pytest keeps them to the session's end, so a
whole run held all of them at once: the port's training, checkpoint,
export and network-file tests write about 9 GB a run (one test 3.7 GB),
enough to fill a small disk, or memory where the temporary directory lives
in it. Import it into a test module to apply it."""
import os
import shutil

import pytest


@pytest.fixture(scope="module", autouse=True)
def drop_module_tmp(tmp_path_factory):
    base = tmp_path_factory.getbasetemp()
    before = set(os.listdir(base))
    yield
    for name in set(os.listdir(base)) - before:
        shutil.rmtree(base / name, ignore_errors=True)
