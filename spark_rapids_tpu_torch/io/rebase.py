"""Legacy hybrid-calendar rebase for parquet date/timestamp columns.

Reference: RebaseHelper.scala:82 + GpuParquetScan.scala:216
(isCorrectedRebaseMode). Files written by Spark < 3.0 (or by Spark 3 in
LEGACY mode, marked with the ``org.apache.spark.legacyDateTime`` file key)
store day/micros counts derived from the HYBRID Julian+Gregorian calendar:
the same y-m-d label maps to a different physical day count than the
proleptic Gregorian calendar every engine (this one included) uses for
dates before the 1582-10-15 cutover. Reading such a file without rebasing
silently shifts ancient dates by up to 10 days (and by -2 days around
0001-01-01).

The detection contract (matching RebaseHelper):
- key ``org.apache.spark.legacyDateTime`` present  -> LEGACY (rebase needed)
- key ``org.apache.spark.version`` >= 3.0 absent the legacy key -> CORRECTED
- no spark version at all (parquet-mr, pyarrow, ...)  -> CORRECTED
  (non-Spark writers use proleptic Gregorian; parquet-mr's deprecated
  int96 path is out of scope here, as it is for the reference's v0)
- spark version < 3.0 -> LEGACY

The conversion itself: stored days -> y/m/d via the JULIAN calendar (all
rebased values predate the cutover, where hybrid == Julian) -> day count of
that label in proleptic Gregorian. Vectorized numpy; identical math to
Spark's RebaseDateTime.rebaseJulianToGregorianDays for every day before the
cutover (anchor: -141428 [Julian 1582-10-04] -> -141438).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

#: first proleptic-Gregorian day of the Gregorian calendar (1582-10-15) as
#: days since 1970-01-01 — stored values at/after this need no rebase
GREGORIAN_CUTOVER_DAYS = -141427

#: julian day number of 1970-01-01 (proleptic Gregorian epoch)
_JDN_EPOCH = 2440588

#: python date.toordinal() of 1970-01-01
_ORDINAL_EPOCH = 719163


def julian_to_gregorian_days(days: np.ndarray) -> np.ndarray:
    """Rebase hybrid-calendar day counts to proleptic Gregorian, preserving
    the y-m-d label (RebaseDateTime.rebaseJulianToGregorianDays)."""
    days = np.asarray(days, np.int64)
    legacy = days < GREGORIAN_CUTOVER_DAYS
    if not legacy.any():
        return days
    jdn = days + _JDN_EPOCH
    # JDN -> Julian-calendar y/m/d (Richards/FRoCC algorithm, branch-free)
    c = jdn + 32082
    d = (4 * c + 3) // 1461
    e = c - (1461 * d) // 4
    m = (5 * e + 2) // 153
    day = e - (153 * m + 2) // 5 + 1
    month = m + 3 - 12 * (m // 10)
    year = d - 4800 + m // 10
    # y/m/d -> proleptic-Gregorian day count (days_from_civil)
    y = year - (month <= 2)
    era = np.where(y >= 0, y, y - 399) // 400
    yoe = y - era * 400
    doy = (153 * (month + np.where(month > 2, -3, 9)) + 2) // 5 + day - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    greg = era * 146097 + doe - 719468
    return np.where(legacy, greg, days)


#: one day in microseconds
_DAY_US = 86_400_000_000


def julian_to_gregorian_micros(micros: np.ndarray) -> np.ndarray:
    """Rebase hybrid-calendar UTC microsecond timestamps: shift the UTC day
    by the same label-preserving day delta (this engine is UTC-only —
    docs/compatibility.md — so no zone-offset component applies)."""
    micros = np.asarray(micros, np.int64)
    days = micros // _DAY_US            # floor: pre-epoch days stay aligned
    legacy = days < GREGORIAN_CUTOVER_DAYS
    if not legacy.any():
        return micros
    delta = (julian_to_gregorian_days(days) - days) * _DAY_US
    return micros + np.where(legacy, delta, 0)


def file_rebase_mode(metadata: Optional[dict]) -> str:
    """'legacy' when the file needs a Julian->Gregorian rebase, else
    'corrected' (RebaseHelper's isCorrectedRebaseMode, inverted)."""
    if not metadata:
        return "corrected"
    if b"org.apache.spark.legacyDateTime" in metadata:
        return "legacy"
    version = metadata.get(b"org.apache.spark.version")
    if version is None:
        return "corrected"
    try:
        major = int(version.decode("ascii").split(".", 1)[0])
    except (UnicodeDecodeError, ValueError):
        return "legacy"          # unparseable spark version: be safe
    return "corrected" if major >= 3 else "legacy"
