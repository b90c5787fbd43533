"""Python-datetime-compatible ordinal day arithmetic (creds/src/daystamp.rs).

A copy of ``crescent_tpu/credentials/daystamp.py``.

The mDL circuits compare `valid_until`/birth-date daystamps in-circuit
(circuit_setup/circuits-mdl/strings.circom Daystamp:221), using cpython's
proleptic-Gregorian ordinal (01-Jan-0001 == day 1)."""

from __future__ import annotations

import datetime

_DAYS_IN_MONTH = [None, 31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31]
_DAYS_BEFORE_MONTH = [None, 0, 31, 59, 90, 120, 151, 181, 212, 243, 273, 304, 334]


def is_leap(year: int) -> bool:
    return year % 4 == 0 and (year % 100 != 0 or year % 400 == 0)


def days_before_year(year: int) -> int:
    y = year - 1
    return y * 365 + y // 4 - y // 100 + y // 400


def days_in_month(year: int, month: int) -> int:
    assert 1 <= month <= 12
    if month == 2 and is_leap(year):
        return 29
    return _DAYS_IN_MONTH[month]


def days_before_month(year: int, month: int) -> int:
    assert 1 <= month <= 12
    return _DAYS_BEFORE_MONTH[month] + (1 if month > 2 and is_leap(year) else 0)


def ymd_to_ordinal(year: int, month: int, day: int) -> int:
    assert 1 <= day <= days_in_month(year, month)
    return days_before_year(year) + days_before_month(year, month) + day


def days_to_be_age(age: int, today: datetime.date | None = None) -> int:
    """How many days old someone must be to be `age` years (daystamp.rs:46)."""
    today = today or datetime.date.today()
    year, month, day = today.year, today.month, today.day
    today_stamp = ymd_to_ordinal(year, month, day)
    if month == 2 and day == 29:
        day = 28
    past_stamp = ymd_to_ordinal(year - age, month, day)
    assert today_stamp > past_stamp
    return today_stamp - past_stamp
