"""KV layer — transactional key-value API over the MVCC LSM engine
(pkg/kv analog: kv.DB, kv.Txn, retries, intents, refresh validation); the
port of ``cockroach_tpu.kv``."""

from ..storage.lsm import WriteIntentError
from .hlc import Clock, ManualClock
from .txn import DB, TransactionAbortedError, TransactionRetryError, Txn

__all__ = [
    "Clock", "ManualClock", "DB", "Txn",
    "TransactionAbortedError", "TransactionRetryError", "WriteIntentError",
]
