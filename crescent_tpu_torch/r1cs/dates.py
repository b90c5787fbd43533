"""Date gadgets for the mDL statement: Lookup / Daystamp / UnixTimestamp.

A copy of ``crescent_tpu/r1cs/dates.py``.

Mirrors circuit_setup/circuits-mdl/strings.circom:111-239 — constant-table
lookups via one-hot point indicators, CPython-ordinal daystamps (days since
year 0, matching credentials/daystamp.ymd_to_ordinal) and the 2024..2040
unix-timestamp year table (UTC-8 epoch values, strings.circom:162).
"""

from __future__ import annotations

from .builder import LC, ConstraintSystem, Var
from .jwt_circuit import less_than, point_indicator

# strings.circom:162 — `date --date=Y-01-01 +%s` in UTC-8 for 2024..2040
YEAR_TS = [
    1704096000, 1735718400, 1767254400, 1798790400, 1830326400, 1861948800,
    1893484800, 1925020800, 1956556800, 1988179200, 2019715200, 2051251200,
    2082787200, 2114409600, 2145945600, 2177481600, 2209017600,
]
YEAR_TS_BASE = 2024

DAYS_BEFORE_MONTH = [-1, 0, 31, 59, 90, 120, 151, 181, 212, 243, 273, 304, 334]

# strings.circom:210 — CPython _days_before_year for 1900..2030
DBY_BASE = 1900


def _days_before_year_table() -> list[int]:
    from ..credentials.daystamp import days_before_year

    return [days_before_year(y) for y in range(DBY_BASE, DBY_BASE + 131)]


def _is_leap_table(base: int, n: int) -> list[int]:
    return [
        1 if (y % 4 == 0 and (y % 100 != 0 or y % 400 == 0)) else 0
        for y in range(base, base + n)
    ]


def lookup(cs: ConstraintSystem, table: list[int], idx) -> Var:
    """Constant-table lookup via point indicator (strings.circom Lookup:111).
    idx must lie in [0, len(table)) for satisfiability."""
    ind = point_indicator(cs, idx, len(table))
    acc = LC()
    for v, c in zip(ind, table):
        if c:
            acc = acc + LC.of(v, c)
    return cs.add_const_mul(acc)


def days_before_month(cs: ConstraintSystem, month, year) -> LC:
    """DaysBeforeMonth (strings.circom:125): table[month] + leap adjustment
    for month > 2."""
    dbm = lookup(cs, DAYS_BEFORE_MONTH, month)
    leap = lookup(cs, _is_leap_table(DBY_BASE, 131), LC.of(year) - LC.of(DBY_BASE))
    gt2 = less_than(cs, 2, month, 16)
    return LC.of(dbm) + LC.of(cs.mul(leap, gt2))


def daystamp(cs: ConstraintSystem, year, month, day) -> Var:
    """Days since year 0 (strings.circom Daystamp:221; CPython toordinal)."""
    dby = lookup(cs, _days_before_year_table(), LC.of(year) - LC.of(DBY_BASE))
    dbm = days_before_month(cs, month, year)
    return cs.add_const_mul(LC.of(dby) + dbm + LC.of(day))


def unix_timestamp(cs: ConstraintSystem, year, month, day) -> Var:
    """Seconds since the unix epoch at Y-M-D 00:00 (UTC-8 table semantics,
    strings.circom UnixTimestamp:149; valid for 2024..2040)."""
    year_ts = lookup(cs, YEAR_TS, LC.of(year) - LC.of(YEAR_TS_BASE))
    dbm = lookup(cs, DAYS_BEFORE_MONTH, month)
    leap = lookup(
        cs, _is_leap_table(YEAR_TS_BASE, len(YEAR_TS)), LC.of(year) - LC.of(YEAR_TS_BASE)
    )
    gt2 = less_than(cs, 2, month, 16)
    days = LC.of(dbm) + LC.of(cs.mul(leap, gt2)) + LC.of(day) - LC.of(1)
    return cs.add_const_mul(LC.of(year_ts) + days.scale(86400))
