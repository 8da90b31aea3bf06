"""TPCx-BB q5 over the DataFrame API, as the JAX package's
``benchmarks/tpcxbb_queries.py`` writes it: the per-user click profile in a
category against the users' demographics. ``QUERIES`` maps its name to it
and ``COLUMNS`` lists the columns it reads (``tpcxbb_data``'s
``columns=``); the other 29 queries are not ported yet."""
from __future__ import annotations

from typing import Dict, List

from spark_rapids_tpu_torch.api import functions as F

col, when = F.col, F.when


def q5(t):
    """Per-user click profile in category vs demographics (logistic-regression
    input vectors; TpcxbbLikeSpark.scala:809)."""
    clicks = (t["web_clickstreams"].filter(col("wcs_user_sk").isNotNull())
              .join(t["item"], [("wcs_item_sk", "i_item_sk")]))
    in_cat = lambda i: F.sum(  # noqa: E731
        when(col("i_category_id") == i, 1).otherwise(0)).alias(f"clicks_in_{i}")
    per_user = (clicks.groupBy("wcs_user_sk")
                .agg(F.sum(when(col("i_category") == "Books", 1).otherwise(0))
                     .alias("clicks_in_category"),
                     *[in_cat(i) for i in range(1, 8)]))
    return (per_user
            .join(t["customer"], [("wcs_user_sk", "c_customer_sk")])
            .join(t["customer_demographics"],
                  [("c_current_cdemo_sk", "cd_demo_sk")])
            .select("clicks_in_category",
                    when(col("cd_education_status").isin(
                        "Advanced Degree", "College", "4 yr Degree",
                        "2 yr Degree"), 1).otherwise(0)
                    .alias("college_education"),
                    when(col("cd_gender") == "M", 1).otherwise(0).alias("male"),
                    *[f"clicks_in_{i}" for i in range(1, 8)]))


QUERIES: Dict[str, object] = {"q5": q5}

COLUMNS: Dict[str, Dict[str, List[str]]] = {
    "q5": {"web_clickstreams": ["wcs_item_sk", "wcs_user_sk"],
           "item": ["i_item_sk", "i_category_id", "i_category"],
           "customer": ["c_customer_sk", "c_current_cdemo_sk"],
           "customer_demographics": ["cd_demo_sk", "cd_gender",
                                     "cd_education_status"]},
}
