from spark_rapids_tpu_torch.api.dataframe import DataFrame, TpuSession

__all__ = ["DataFrame", "TpuSession"]
