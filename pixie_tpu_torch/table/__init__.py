from pixie_tpu_torch.table.dictionary import Dictionary
from pixie_tpu_torch.table.row_batch import RowBatch
from pixie_tpu_torch.table.table import Table, TableStore

__all__ = ["Dictionary", "RowBatch", "Table", "TableStore"]
