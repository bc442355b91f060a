"""Postgres plane (gated on SQLAlchemy).

Copy of ``audio_processing_tools_tpu/io/db.py`` for the port (the card's
machine has no JAX); SQLAlchemy and pandas are imported inside the
functions that use them.

Capabilities (parity with the reference's DB tooling): run SQL into a
DataFrame sorted by its ``time`` column when present, and upsert a DataFrame
into a table keyed on its index — creating the table and its unique
constraint on first write, otherwise staging through a temp table and
issuing ``INSERT ... ON CONFLICT DO UPDATE``.
"""

from __future__ import annotations

import uuid
from typing import Dict, Optional


def _require_sqlalchemy():
    try:
        import sqlalchemy  # noqa: F401

        return sqlalchemy
    except ImportError as e:
        raise ImportError(
            "SQLAlchemy is required for database operations but is not "
            "installed."
        ) from e


def get_db_data(query: str, db_engine, *, params: Optional[dict] = None):
    """SQL -> DataFrame; rows ordered by 'time' when that column exists."""
    _require_sqlalchemy()
    import pandas as pd
    from sqlalchemy import text

    try:
        with db_engine.connect() as conn:
            df = pd.read_sql_query(text(query), conn, params=params)
    except Exception as e:
        raise RuntimeError(
            "Database query failed. Check connection or VPN status."
        ) from e
    if "time" in df.columns:
        df = df.sort_values("time").reset_index(drop=True)
    return df


class _UpsertPlan:
    """SQL fragments for an index-keyed upsert of one DataFrame."""

    def __init__(self, df, table_name: str, schema: str):
        if df.index.names == [None] or any(n is None for n in df.index.names):
            df = df.copy()
            df.index.name = df.index.name or "idx"
        self.df = df
        self.table = table_name
        self.schema = schema
        self.key_cols = list(df.index.names)
        self.value_cols = list(df.columns)

    def quoted(self, cols):
        return ", ".join(f'"{c}"' for c in cols)

    @property
    def constraint(self) -> str:
        return f"uq_upsert_{self.table}_" + "_".join(self.key_cols)

    @property
    def qualified(self) -> str:
        return f'"{self.schema}"."{self.table}"'

    def conflict_sql(self, staging: str) -> str:
        every = self.quoted(self.key_cols + self.value_cols)
        updates = ", ".join(
            f'"{c}" = EXCLUDED."{c}"' for c in self.value_cols
        )
        return (
            f"INSERT INTO {self.qualified} ({every}) "
            f'SELECT {every} FROM "{self.schema}"."{staging}" '
            f"ON CONFLICT ({self.quoted(self.key_cols)}) DO UPDATE SET {updates}"
        )


def _table_exists(conn, schema: str, name: str) -> bool:
    from sqlalchemy import text

    return conn.execute(
        text(
            "SELECT EXISTS (SELECT FROM information_schema.tables "
            "WHERE table_schema = :schema AND table_name = :name)"
        ),
        {"schema": schema, "name": name},
    ).scalar_one()


def upsert_df(df, table_name: str, engine, *, schema: str = "public",
              chunksize: int = 1000,
              dtype: Optional[Dict[str, object]] = None) -> bool:
    """Index-keyed Postgres upsert (create-if-missing, temp-table staging)."""
    _require_sqlalchemy()
    from sqlalchemy import text

    plan = _UpsertPlan(df, table_name, schema)

    with engine.begin() as conn:
        if not _table_exists(conn, schema, table_name):
            plan.df.to_sql(table_name, conn, schema=schema, index=True,
                           if_exists="fail", chunksize=chunksize, dtype=dtype)
            conn.execute(text(
                f"ALTER TABLE {plan.qualified} ADD CONSTRAINT "
                f"{plan.constraint} UNIQUE ({plan.quoted(plan.key_cols)})"
            ))
            return True

        staging = f"tmp_{table_name}_{uuid.uuid4().hex[:6]}"
        plan.df.to_sql(staging, conn, schema=schema, index=True,
                       if_exists="replace", chunksize=chunksize, dtype=dtype)
        conn.execute(text(
            f"ALTER TABLE {plan.qualified} DROP CONSTRAINT IF EXISTS "
            f"{plan.constraint}"
        ))
        conn.execute(text(
            f"ALTER TABLE {plan.qualified} ADD CONSTRAINT {plan.constraint} "
            f"UNIQUE ({plan.quoted(plan.key_cols)})"
        ))
        conn.execute(text(plan.conflict_sql(staging)))
        conn.execute(text(f'DROP TABLE "{schema}"."{staging}"'))
    return True
