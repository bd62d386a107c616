"""COSMO-1 archive fetcher.

A copy of ``windtpu/preprocess/download_cosmo.py`` (ftplib and pandas),
kept so the port imports nothing of the JAX package;
tests/test_torch_copies.py pins it to the original.

Talks to the same UniBe FTP archive as the reference tool
(download_COSMO1.py:13-41) — host, directory layout and the hourly
``cosmo-1_*_YYYYMMDDHH.nc`` naming are that server's contract — but the
tool itself is hardened beyond the reference:

* per-file retry with exponential backoff and automatic reconnect
  (stalled FTP data channels are routine on this server);
* resume-safe: partial transfers land in ``*.part`` and are only renamed
  once complete, so a killed run never leaves truncated hourly files that
  a later run would mistake for good ones;
* a day whose merged output exists is never re-fetched (idempotent, same
  as the reference).
"""

from __future__ import annotations

import re
import time
from ftplib import FTP, error_temp
from pathlib import Path

import pandas as pd

ARCHIVE_HOST = "giub-torrent.unibe.ch"
ARCHIVE_DIR = "COSMO-1_test"


def _merged_name(day) -> str:
    return f"{day.year}{day.month:02d}{day.day:02d}.nc"


def _hourly_regex(day) -> re.Pattern:
    stamp = f"{day.year}{day.month:02d}{day.day:02d}"
    return re.compile(rf"cosmo-1_\w+_{stamp}\d\d\.nc")


def _fetch_with_retry(connect, conn, remote: str, dest: Path,
                      attempts: int = 3):
    """RETR ``remote`` into ``dest`` atomically; reconnect between tries."""
    partial = dest.with_suffix(dest.suffix + ".part")
    for attempt in range(attempts):
        try:
            with open(partial, "wb") as fp:
                conn.retrbinary(f"RETR {remote}", fp.write)
            partial.rename(dest)
            return conn
        except (error_temp, OSError, EOFError) as exc:
            partial.unlink(missing_ok=True)
            if attempt == attempts - 1:
                raise
            wait = 2.0 ** attempt
            print(f"transfer of {remote} failed ({exc}); "
                  f"retrying in {wait:.0f}s")
            time.sleep(wait)
            try:
                conn.quit()
            except Exception:
                pass
            conn = connect()
    return conn


def download_COSMO1(username, password, datapath, start_date, end_date,
                    timeout: float = 200.0):
    """Mirror the hourly COSMO-1 files for [start_date, end_date] and merge
    each day into one ``YYYYMMDD.nc`` (hourly parts are removed after a
    successful merge)."""
    from windtpu_torch.io.dataset import open_mfdataset

    out_dir = Path(datapath)
    out_dir.mkdir(parents=True, exist_ok=True)

    def connect() -> FTP:
        c = FTP(ARCHIVE_HOST, username, password, timeout=timeout)
        c.cwd(ARCHIVE_DIR)
        return c

    conn = connect()
    try:
        available = []
        conn.retrlines("NLST", available.append)
        for day in pd.date_range(start_date, end_date):
            merged = out_dir / _merged_name(day)
            if merged.exists():
                continue
            rx = _hourly_regex(day)
            hourly = sorted(f for f in available if rx.match(f))
            if not hourly:
                print(f"{day.date()}: nothing on the archive, skipping")
                continue
            parts = []
            for remote in hourly:
                local = out_dir / remote.split("_")[-1]
                if not local.exists():
                    print(f"{day.date()}: fetching {remote}")
                    conn = _fetch_with_retry(connect, conn, remote, local)
                parts.append(local)
            print(f"{day.date()}: merging {len(parts)} hourly files "
                  f"-> {merged.name}")
            open_mfdataset([str(p) for p in parts]).to_netcdf(merged)
            for p in parts:
                p.unlink()
    finally:
        try:
            conn.quit()
        except Exception:
            pass
    print(f"COSMO-1 mirror of {out_dir} is up to date")
