"""A working directory that no longer exists, for the port's tests.

A test run earlier in the same process may leave the process in a removed
directory (the workspace pools of both packages change into sample
directories and delete them). The port's entry points must not need one
where ``mlmc_tpu``'s do not; ``removed_working_directory`` puts a call in
that state and restores the directory it started in.
"""
import contextlib
import os


@contextlib.contextmanager
def removed_working_directory(tmp_path):
    """Change into a fresh directory under ``tmp_path``, remove it, yield;
    then change back to the directory the process was in (if it had one)."""
    try:
        start = os.getcwd()
    except FileNotFoundError:
        start = None
    gone = tmp_path / "removed_cwd"
    gone.mkdir()
    os.chdir(gone)
    try:
        gone.rmdir()
        yield
    finally:
        if start is not None:
            os.chdir(start)
