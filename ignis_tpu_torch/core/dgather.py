"""Row gather for parameter tables.  ignis_tpu/core/dgather.py rewrites the
gather as a one-hot matrix product for its backend; here it is plain indexing
(autograd supplies the scatter-add)."""


def gather_rows(table, idx):
    return table[idx.long()]
