"""Mortgage ETL benchmark (the JAX package's ``benchmarks/mortgage.py``;
reference: MortgageSpark.scala, the Fannie Mae single-family loan
performance ETL).

The ETL functions are the JAX package's text with the port's imports:
seller-name normalization through a mapping-table left join, per-loan
delinquency milestones (the ever_30/90/180 aggregation and the 12-month
window through an ``explode`` of a literal month array), the acquisition
cleanup and the final prime join. The generators draw the same random
numbers in the same order as the JAX package's, so a (scale, seed) gives
the same rows, and build the host layout directly (no pyarrow); dates are
day numbers, computed by numpy instead of one ``datetime`` per row.
"""
from __future__ import annotations

import numpy as np

from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.api.dataframe import DataFrame
from spark_rapids_tpu_torch.benchmarks.tpch_data import _strings, _values
from spark_rapids_tpu_torch.columnar.dtypes import DType, Field, Schema
from spark_rapids_tpu_torch.columnar.host import (HostBatch, HostColumn,
                                                  string_batch)

col, lit, when = F.col, F.lit, F.when

#: NameMapping analog (MortgageSpark.scala:120): raw seller spellings to
#: canonical names
NAME_MAPPING = [
    ("WITMER FINANCING, INC", "Witmer"),
    ("WITMER FINANCING INC", "Witmer"),
    ("BANK OF AMERICA, N.A.", "Bank of America"),
    ("BANK OF AMERICA NA", "Bank of America"),
    ("QUICKEN LOANS INC.", "Quicken Loans"),
    ("QUICKEN LOANS, INC.", "Quicken Loans"),
    ("WELLS FARGO BANK, N.A.", "Wells Fargo"),
    ("WELLS FARGO BANK NA", "Wells Fargo"),
    ("FLAGSTAR BANK, FSB", "Flagstar Bank"),
    ("PENNYMAC CORP.", "PennyMac"),
]
_RAW_SELLERS = [m[0] for m in NAME_MAPPING] + ["OTHER", "UNMAPPED LENDER LLC"]


def n_loans(scale: float) -> int:
    return max(int(10_000 * scale), 200)


def _first_of_month_days(year: np.ndarray, month: np.ndarray) -> np.ndarray:
    """Days since 1970-01-01 of the first day of each (year, month)."""
    months = (year.astype(np.int64) - 1970) * 12 + (month.astype(np.int64)
                                                     - 1)
    return months.astype("datetime64[M]").astype("datetime64[D]") \
        .astype(np.int64).astype(np.int32)


def _batch(cols) -> HostBatch:
    """(name, dtype, column) triples -> a HostBatch."""
    return HostBatch(Schema([Field(n, dt) for n, dt, _ in cols]),
                     tuple(c for _, _, c in cols), cols[0][2].data.shape[0])


def _quarters(rng, loans: int) -> np.ndarray:
    return np.char.add(
        rng.integers(2000, 2008, loans).astype(str),
        np.char.add("Q", rng.integers(1, 5, loans).astype(str)))


def gen_performance(scale: float = 0.02, seed: int = 0) -> HostBatch:
    loans = n_loans(scale)
    rng = np.random.default_rng(seed + 21)
    months_per = rng.integers(6, 37, loans)
    loan_id = np.repeat(np.arange(1, loans + 1, dtype=np.int64), months_per)
    n = loan_id.shape[0]
    quarter = _quarters(rng, loans)
    start = rng.integers(0, 12 * 8, loans)  # months after 2000-01
    seq = (np.arange(n, dtype=np.int64)
           - np.repeat(np.cumsum(months_per) - months_per, months_per))
    month_idx = start[loan_id - 1] + seq
    period = _first_of_month_days(2000 + month_idx // 12, month_idx % 12 + 1)
    # delinquency mostly 0; troubled loans escalate
    troubled = rng.random(loans) < 0.2
    status = np.where(np.repeat(troubled, months_per),
                      rng.integers(0, 10, n), 0).astype(np.int32)
    upb = np.round(np.repeat(rng.uniform(50_000, 500_000, loans), months_per)
                   * (1 - seq * 0.01), 2)
    upb = np.where(rng.random(n) < 0.01, 0.0, upb)
    servicer = np.array(_RAW_SELLERS)[rng.integers(0, len(_RAW_SELLERS),
                                                   loans)]
    rate = np.round(rng.uniform(2.5, 8.0, loans), 3)
    return _batch([
        ("quarter", DType.STRING, _repeat(_strings(quarter), months_per)),
        ("loan_id", DType.LONG, _values(DType.LONG, loan_id)),
        ("monthly_reporting_period", DType.DATE, _values(DType.DATE, period)),
        ("current_loan_delinquency_status", DType.INT,
         _values(DType.INT, status)),
        ("current_actual_upb", DType.DOUBLE, _values(DType.DOUBLE, upb)),
        ("servicer", DType.STRING, _repeat(_strings(servicer), months_per)),
        ("interest_rate", DType.DOUBLE,
         _values(DType.DOUBLE, np.repeat(rate, months_per))),
    ])


def _repeat(c: HostColumn, counts: np.ndarray) -> HostColumn:
    """Each row of a string column repeated ``counts`` times."""
    return HostColumn(c.dtype, np.repeat(c.data, counts, axis=0),
                      np.repeat(c.validity, counts),
                      np.repeat(c.lengths, counts))


def gen_acquisition(scale: float = 0.02, seed: int = 0) -> HostBatch:
    loans = n_loans(scale)
    rng = np.random.default_rng(seed + 22)
    loan_id = np.arange(1, loans + 1, dtype=np.int64)
    # quarters must line up with the performance table's per-loan quarter
    perf_rng = np.random.default_rng(seed + 21)
    perf_rng.integers(6, 37, loans)  # consume months_per draw
    quarter = _quarters(perf_rng, loans)
    orig = rng.integers(0, 12 * 8, loans)
    orig_date = _first_of_month_days(2000 + orig // 12, orig % 12 + 1)
    sellers = np.array(_RAW_SELLERS)[rng.integers(0, len(_RAW_SELLERS),
                                                  loans)]
    rate = np.round(rng.uniform(2.5, 8.0, loans), 3)
    upb = np.round(rng.uniform(50_000, 500_000, loans), 2)
    term = rng.choice([180, 240, 360], loans).astype(np.int32)
    ltv = np.round(rng.uniform(40, 97, loans), 1)
    dti = np.round(rng.uniform(10, 50, loans), 1)
    score = rng.integers(550, 840, loans).astype(np.int32)
    state = np.array(["CA", "TX", "NY", "FL", "IL", "WA", "CO"])[
        rng.integers(0, 7, loans)]
    return _batch([
        ("loan_id", DType.LONG, _values(DType.LONG, loan_id)),
        ("quarter", DType.STRING, _strings(quarter)),
        ("seller_name", DType.STRING, _strings(sellers)),
        ("orig_date", DType.DATE, _values(DType.DATE, orig_date)),
        ("first_pay_date", DType.DATE, _values(DType.DATE, orig_date + 31)),
        ("orig_interest_rate", DType.DOUBLE, _values(DType.DOUBLE, rate)),
        ("orig_upb", DType.DOUBLE, _values(DType.DOUBLE, upb)),
        ("orig_loan_term", DType.INT, _values(DType.INT, term)),
        ("orig_ltv", DType.DOUBLE, _values(DType.DOUBLE, ltv)),
        ("dti", DType.DOUBLE, _values(DType.DOUBLE, dti)),
        ("borrower_credit_score", DType.INT, _values(DType.INT, score)),
        ("state", DType.STRING, _strings(state)),
    ])


def create_performance_delinquency(perf: DataFrame) -> DataFrame:
    """CreatePerformanceDelinquency.apply analog (MortgageSpark.scala:229)."""
    base = perf.withColumn("timestamp_month",
                           F.month("monthly_reporting_period")) \
               .withColumn("timestamp_year",
                           F.year("monthly_reporting_period"))
    agg_df = (perf.select(
        "quarter", "loan_id", "current_loan_delinquency_status",
        when(col("current_loan_delinquency_status") >= 1,
             col("monthly_reporting_period")).alias("delinquency_30"),
        when(col("current_loan_delinquency_status") >= 3,
             col("monthly_reporting_period")).alias("delinquency_90"),
        when(col("current_loan_delinquency_status") >= 6,
             col("monthly_reporting_period")).alias("delinquency_180"))
        .groupBy("quarter", "loan_id")
        .agg(F.max("current_loan_delinquency_status").alias("delinquency_12"),
             F.min("delinquency_30").alias("delinquency_30"),
             F.min("delinquency_90").alias("delinquency_90"),
             F.min("delinquency_180").alias("delinquency_180"))
        .select("quarter", "loan_id",
                (col("delinquency_12") >= 1).alias("ever_30"),
                (col("delinquency_12") >= 3).alias("ever_90"),
                (col("delinquency_12") >= 6).alias("ever_180"),
                "delinquency_30", "delinquency_90", "delinquency_180"))

    joined = (base
              .withColumnRenamed("monthly_reporting_period", "timestamp")
              .withColumnRenamed("current_loan_delinquency_status",
                                 "delinquency_12")
              .withColumnRenamed("current_actual_upb", "upb_12")
              .select("quarter", "loan_id", "timestamp", "delinquency_12",
                      "upb_12", "timestamp_month", "timestamp_year")
              .join(agg_df, ["loan_id", "quarter"], "left"))

    months = 12
    mody = (col("timestamp_year") * 12 + col("timestamp_month")) - 24000
    test_df = (joined
               .select("quarter", "loan_id", "ever_30", "ever_90", "ever_180",
                       "delinquency_30", "delinquency_90", "delinquency_180",
                       "delinquency_12", "upb_12", "timestamp_month",
                       "timestamp_year",
                       F.explode(list(range(12))).alias("month_y"))
               .select("quarter", "loan_id", "ever_30", "ever_90", "ever_180",
                       "delinquency_30", "delinquency_90", "delinquency_180",
                       "delinquency_12", "upb_12", "month_y",
                       F.floor((mody - col("month_y")) / float(months))
                       .alias("josh_mody_n"))
               .groupBy("quarter", "loan_id", "josh_mody_n", "ever_30",
                        "ever_90", "ever_180", "delinquency_30",
                        "delinquency_90", "delinquency_180", "month_y")
               .agg(F.max("delinquency_12").alias("delinquency_12"),
                    F.min("upb_12").alias("upb_12"))
               .withColumn("timestamp_year",
                           F.floor((lit(24000) + col("josh_mody_n") * months
                                    + (col("month_y") - 1)) / 12.0))
               .withColumn("timestamp_month_tmp",
                           F.pmod(lit(24000) + col("josh_mody_n") * months
                                  + col("month_y"), lit(12)))
               .withColumn("timestamp_month",
                           when(col("timestamp_month_tmp") == 0, 12)
                           .otherwise(col("timestamp_month_tmp")))
               .withColumn("delinquency_12",
                           (col("delinquency_12") > 3).cast("int")
                           + (col("upb_12") == 0).cast("int"))
               .drop("timestamp_month_tmp", "josh_mody_n", "month_y"))

    out = (base
           .withColumn("timestamp_year", col("timestamp_year").cast("double"))
           .withColumn("timestamp_month", col("timestamp_month").cast("double"))
           .join(test_df,
                 ["quarter", "loan_id", "timestamp_year", "timestamp_month"],
                 "left")
           .drop("timestamp_year", "timestamp_month"))
    return out


def create_acquisition(acq: DataFrame) -> DataFrame:
    """CreateAcquisition analog (MortgageSpark.scala:301)."""
    session = acq.session
    mapping = session.create_dataframe(string_batch(
        ["from_seller_name", "to_seller_name"],
        [list(m) for m in NAME_MAPPING]))
    return (acq.join(mapping, [("seller_name", "from_seller_name")], "left")
            .drop("from_seller_name")
            .withColumn("old_name", col("seller_name"))
            .withColumn("seller_name", F.coalesce(col("to_seller_name"),
                                                  col("seller_name")))
            .drop("to_seller_name"))


def clean_acquisition_prime(perf: DataFrame, acq: DataFrame) -> DataFrame:
    """CleanAcquisitionPrime analog: the full ETL output."""
    p = create_performance_delinquency(perf)
    a = create_acquisition(acq)
    return p.join(a, ["loan_id", "quarter"]).drop("quarter")


def simple_aggregates(perf: DataFrame, acq: DataFrame) -> DataFrame:
    """SimpleAggregates.csv analog (MortgageSpark.scala:349)."""
    return (clean_acquisition_prime(perf, acq)
            .groupBy("seller_name", "state")
            .agg(F.count().alias("loans"),
                 F.avg("interest_rate").alias("avg_rate"),
                 F.max("delinquency_12").alias("max_delinquency_12"),
                 F.sum("upb_12").alias("total_upb"))
            .sort("seller_name", "state"))
