"""Data providers: resolve a date string to a local file path.

Functional twins of the reference providers (data_generator.py:21-93):
an abstract Provider with load/unload/provide, a local-filesystem provider
that discovers dates by matching a ``{date[:fmt]}`` filename pattern, and an
S3 provider shelling out to ``s3cmd``.  Pattern parsing is a small regex
(the ``parse`` package is not in the TPU image).  A copy of
``windtpu/data/providers.py``, pinned to it by
``tests/test_torch_copies.py``.
"""

from __future__ import annotations

import abc
import os
import re
import subprocess
import shutil
import tempfile
from contextlib import contextmanager
from pathlib import Path
from typing import Collection


def _pattern_to_regex(pattern: str) -> "re.Pattern":
    """Turn a ``{date}``/``{date:d}``-style filename pattern into a regex
    with a ``date`` capture group."""
    out = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if ch == "{":
            j = pattern.index("}", i)
            field = pattern[i + 1:j]
            name = field.split(":")[0]
            if name == "date":
                out.append(r"(?P<date>\d+)")
            else:
                out.append(r".*?")
            i = j + 1
        else:
            out.append(re.escape(ch))
            i += 1
    return re.compile("^" + "".join(out) + "$")


class Provider(abc.ABC):
    available_dates: Collection[str]

    @abc.abstractmethod
    def load(self, date: str) -> os.PathLike:
        ...

    def unload(self, loaded: os.PathLike) -> None:
        pass

    @contextmanager
    def provide(self, date):
        loaded = None
        try:
            loaded = self.load(date)
            yield loaded
        finally:
            if loaded is not None:
                self.unload(loaded)


class LocalFileProvider(Provider):
    """Finds ``pattern.format(date=...)`` files under a directory."""

    def __init__(self, path_to_data: os.PathLike, pattern: str):
        self.data_path = Path(path_to_data)
        if "{date" not in pattern:
            raise ValueError("Expected a {date[:fmt]} placeholder in " + pattern)
        self.pattern = pattern
        self._regex = _pattern_to_regex(pattern)

    @property
    def available_dates(self):
        dates = set()
        for f in self.data_path.iterdir():
            m = self._regex.match(str(f.relative_to(self.data_path)))
            if m:
                dates.add(m.group("date"))
        return dates

    def load(self, date: str) -> os.PathLike:
        return self.data_path / _substitute_date(self.pattern, date)


def _substitute_date(pattern: str, date: str) -> str:
    """Replace the ``{date...}`` placeholder with the date string as-is.

    The date must round-trip exactly through ``available_dates`` →
    ``load``: coercing through int() would turn a zero-padded '0101'
    listing hit into a request for the non-existent '101' object.
    """
    if not str(date).isdigit():
        raise ValueError(f"date must be digits, got {date!r}")
    return re.sub(r"\{date[^}]*\}", str(date), pattern)


class _ObjectStoreProvider(Provider):
    """Shared engine for CLI-backed object stores (s3cmd, gsutil).

    Subclasses set ``scheme`` and the two command stems; listing parse
    and temp-file lifecycle are identical.  Tool failures surface loudly:
    a silent empty listing (bad credentials, missing binary, bucket typo)
    would otherwise masquerade as "no training dates available".
    """

    scheme: str              # e.g. "s3" / "gs"
    ls_cmd: tuple            # e.g. ("s3cmd", "ls")
    fetch_cmd: tuple         # e.g. ("s3cmd", "get")

    def __init__(self, bucket: str, *subfolders: str, pattern: str = None):
        if pattern is None:
            pattern = subfolders[-1]
            subfolders = subfolders[:-1]
        bucket = bucket.removeprefix(f"{self.scheme}://")
        self.bucket = "/".join([bucket] + list(subfolders))
        if "{date" not in pattern:
            raise ValueError("Expected a {date} placeholder in " + pattern)
        self.pattern = pattern
        self._regex = _pattern_to_regex(pattern)
        self._tempdirs: dict = {}

    def _url(self, name: str = "") -> str:
        return f"{self.scheme}://{self.bucket}/{name}"

    def _run(self, argv) -> subprocess.CompletedProcess:
        try:
            result = subprocess.run(argv, capture_output=True)
        except OSError as e:
            raise RuntimeError(
                f"{argv[0]} not runnable (needed by "
                f"{type(self).__name__}): {e}") from e
        if result.returncode != 0:
            raise RuntimeError(
                f"{' '.join(argv)} failed rc={result.returncode}: "
                f"{result.stderr.decode(errors='replace').strip()[-500:]}")
        return result

    @property
    def available_dates(self):
        result = self._run([*self.ls_cmd, self._url()])
        dates = set()
        for line in result.stdout.decode().splitlines():
            name = line.strip().rsplit("/", 1)[-1]
            m = self._regex.match(name)
            if m:
                dates.add(m.group("date"))
        return dates

    def load(self, date: str) -> str:
        dest = tempfile.mkdtemp()
        name = _substitute_date(self.pattern, date)
        try:
            self._run([*self.fetch_cmd, self._url(name), dest + "/"])
        except Exception:
            shutil.rmtree(dest, ignore_errors=True)  # no orphan tempdir
            raise
        path = f"{dest}/{name}"
        self._tempdirs[path] = dest
        return path

    def unload(self, loaded) -> None:
        # Remove the whole per-load mkdtemp root (not just the file: for
        # patterns with a subdirectory, the file's parent isn't the root).
        root = self._tempdirs.pop(str(loaded), None)
        if root is not None:
            shutil.rmtree(root, ignore_errors=True)
        else:
            Path(loaded).unlink(missing_ok=True)


class S3FileProvider(_ObjectStoreProvider):
    """Lists/downloads via the ``s3cmd`` CLI into a tempdir (functional
    twin of the reference's S3 provider, data_generator.py:65-93)."""

    scheme = "s3"
    ls_cmd = ("s3cmd", "ls")
    fetch_cmd = ("s3cmd", "get")


class GCSFileProvider(_ObjectStoreProvider):
    """Lists/downloads from Google Cloud Storage via the ``gsutil`` CLI.

    The idiomatic store for TPU-pod training data (SURVEY.md §2 providers
    row): GCS sits next to the TPU hosts, so day files stream in at full
    bandwidth without a POSIX mount.  No reference counterpart (the
    reference has Local + S3 only, data_generator.py:42-93).
    """

    scheme = "gs"
    ls_cmd = ("gsutil", "ls")
    fetch_cmd = ("gsutil", "cp")
