"""The split of `test_build_step_all` over tests/test_wrappers_golden*.py
takes every task of the registry once, so that a task added later cannot
drop out of the build check."""
import importlib
import os

from _wrappers_golden_common import ALL_TASKS, BUILD_TASKS

HERE = os.path.dirname(os.path.abspath(__file__))


def test_build_step_all_takes_every_task_once():
    per_file = {}
    for name in sorted(os.listdir(HERE)):
        if name.startswith("test_wrappers_golden") and name.endswith(".py"):
            test = getattr(importlib.import_module(name[:-3]), "test_build_step_all", None)
            if test is not None:
                (mark,) = [m for m in test.pytestmark if m.name == "parametrize"]
                per_file[name] = tuple(mark.args[1])
    assert per_file == BUILD_TASKS
    tasks = [task for file_tasks in per_file.values() for task in file_tasks]
    assert len(tasks) == len(set(tasks))
    assert sorted(tasks) == ALL_TASKS
