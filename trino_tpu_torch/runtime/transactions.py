"""Transaction management: explicit START TRANSACTION / COMMIT / ROLLBACK
with per-table pre-image undo for writable (memory) catalogs.

The port's copy of ``trino_tpu.runtime.transactions`` (ref:
io.trino.transaction.InMemoryTransactionManager: beginTransaction,
asyncCommit/asyncAbort, idle-timeout expiry). Writes inside an explicit
transaction snapshot the table's page list and ROLLBACK restores it. The
reference's snapshot is a shallow copy of immutable arrays; here it is a
shallow copy of torch tensors, which is a snapshot only because nothing
writes into a stored tensor (DML builds new ones, ``runtime/dml.py``). The
pre-image keeps the old device pages alive until COMMIT or ROLLBACK, so a
table rewritten inside a transaction holds two copies on the device.
"""

from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional, Tuple


class TransactionError(RuntimeError):
    pass


class TxnState(Enum):
    ACTIVE = "ACTIVE"
    COMMITTED = "COMMITTED"
    ABORTED = "ABORTED"


@dataclass
class _TableUndo:
    """Pre-image of one table at first touch inside the transaction."""

    connector: object
    existed: bool
    columns: Optional[tuple] = None
    pages: Optional[list] = None


@dataclass
class Transaction:
    txn_id: str
    read_only: bool = False
    isolation: str = "SERIALIZABLE"
    state: TxnState = TxnState.ACTIVE
    create_time: float = field(default_factory=time.time)
    last_access: float = field(default_factory=time.time)
    # (catalog, SchemaTableName) -> pre-image
    undo: Dict[Tuple[str, object], _TableUndo] = field(default_factory=dict)

    def touch(self) -> None:
        self.last_access = time.time()


class TransactionManager:
    """Tracks transactions; expires idle ones (InMemoryTransactionManager's
    idle-check task)."""

    def __init__(self, idle_timeout: float = 300.0):
        self._lock = threading.Lock()
        self._txns: Dict[str, Transaction] = {}
        self._idle_timeout = idle_timeout

    def begin(self, read_only: bool = False, isolation: str = "SERIALIZABLE") -> Transaction:
        txn = Transaction(
            txn_id=f"tx_{uuid.uuid4().hex[:16]}",
            read_only=read_only,
            isolation=isolation,
        )
        with self._lock:
            stale = self._expire_idle()
            self._txns[txn.txn_id] = txn
        for t in stale:
            self._restore(t)
        return txn

    def get(self, txn_id: str) -> Transaction:
        with self._lock:
            txn = self._txns.get(txn_id)
        if txn is None or txn.state is not TxnState.ACTIVE:
            raise TransactionError(f"unknown or inactive transaction: {txn_id}")
        txn.touch()
        return txn

    def record_pre_image(self, txn: Transaction, catalog: str, connector, st) -> None:
        """Snapshot a table before its first mutation in this transaction.
        Page lists are copied shallowly: no stored tensor is written in place."""
        if txn.state is not TxnState.ACTIVE:
            raise TransactionError(
                f"transaction {txn.txn_id} is no longer active "
                f"({txn.state.value}); writes are not allowed"
            )
        if txn.read_only:
            raise TransactionError("transaction is READ ONLY")
        key = (catalog, st)
        if key in txn.undo:
            return
        table = connector.table(st) if hasattr(connector, "table") else None
        if table is None:
            txn.undo[key] = _TableUndo(connector=connector, existed=False)
        else:
            txn.undo[key] = _TableUndo(
                connector=connector,
                existed=True,
                columns=tuple(table.columns),
                pages=list(table.pages),
            )

    def commit(self, txn: Transaction) -> None:
        with self._lock:
            if txn.state is not TxnState.ACTIVE:
                raise TransactionError(f"transaction not active: {txn.txn_id}")
            txn.state = TxnState.COMMITTED
            txn.undo.clear()
            self._txns.pop(txn.txn_id, None)

    def rollback(self, txn: Transaction) -> None:
        with self._lock:
            if txn.state is not TxnState.ACTIVE:
                raise TransactionError(f"transaction not active: {txn.txn_id}")
            txn.state = TxnState.ABORTED
            self._txns.pop(txn.txn_id, None)
        # restore pre-images outside the manager lock (connector locks inside)
        self._restore(txn)

    @staticmethod
    def _restore(txn: Transaction) -> None:
        for (catalog, st), undo in txn.undo.items():
            conn = undo.connector
            current = conn.table(st)
            if undo.existed:
                if current is not None:
                    # dropped and re-created with a different schema inside the
                    # txn: rebuild with the ORIGINAL column metadata, not just
                    # the original pages
                    conn.drop_table(st, if_exists=True)
                conn.create_table(st, undo.columns)
                conn.replace_pages(st, undo.pages)
            elif current is not None:
                conn.drop_table(st, if_exists=True)
        txn.undo.clear()

    def list_transactions(self) -> List[Transaction]:
        with self._lock:
            return list(self._txns.values())

    def _expire_idle(self) -> List[Transaction]:
        """Collect and abort idle transactions (caller holds the lock; the
        caller must _restore() each returned txn OUTSIDE the lock — an
        idle-expired txn's writes must be undone, not silently committed)."""
        now = time.time()
        stale = [
            t
            for t in self._txns.values()
            if now - t.last_access > self._idle_timeout
        ]
        for t in stale:
            t.state = TxnState.ABORTED
            self._txns.pop(t.txn_id, None)
        return stale
