"""Copy of biokanga_tpu/utils/sqlite_summaries.py: `SQLiteSummaries`.

Experiment, process, parameter and result logging for the CLI's `-q`
flag (CSQLiteSummaries::StartExperiment/AddProcess/AddParameter/AddResult,
biokanga/SQLiteSummaries.cpp:600,719,1057).  The loaders of that module
(snps2sqlite and the others) are not copied.  Python's sqlite3 replaces
the vendored sqlite3.c.
"""
from __future__ import annotations

import json
import sqlite3
import time


class SQLiteSummaries:
    """Experiment/process/parameter/result logging."""

    def __init__(self, db_path: str):
        self.con = sqlite3.connect(db_path)
        self.con.executescript(
            """
            CREATE TABLE IF NOT EXISTS TblExperiments (
              ExprID INTEGER PRIMARY KEY ASC,
              ExprName TEXT, ExprDescr TEXT, Started REAL);
            CREATE TABLE IF NOT EXISTS TblProcesses (
              ProcessID INTEGER PRIMARY KEY ASC,
              ExprID INTEGER, ProcName TEXT, Started REAL, Finished REAL,
              ResultCode INTEGER);
            CREATE TABLE IF NOT EXISTS TblParameters (
              ParamID INTEGER PRIMARY KEY ASC,
              ExprID INTEGER, ProcessID INTEGER,
              ParamName TEXT, ParamValue TEXT);
            CREATE TABLE IF NOT EXISTS TblResults (
              ResultID INTEGER PRIMARY KEY ASC,
              ExprID INTEGER, ProcessID INTEGER,
              ResultName TEXT, ResultValue TEXT);
            """
        )
        self.con.commit()

    def start_experiment(self, name: str, descr: str = "") -> int:
        cur = self.con.execute(
            "INSERT INTO TblExperiments (ExprName, ExprDescr, Started) "
            "VALUES (?,?,?)",
            (name, descr, time.time()),
        )
        self.con.commit()
        return cur.lastrowid

    def add_process(self, expr_id: int, proc_name: str) -> int:
        cur = self.con.execute(
            "INSERT INTO TblProcesses (ExprID, ProcName, Started) "
            "VALUES (?,?,?)",
            (expr_id, proc_name, time.time()),
        )
        self.con.commit()
        return cur.lastrowid

    def add_parameter(self, expr_id, proc_id, name, value) -> int:
        cur = self.con.execute(
            "INSERT INTO TblParameters (ExprID, ProcessID, ParamName, "
            "ParamValue) VALUES (?,?,?,?)",
            (expr_id, proc_id, name, json.dumps(value)),
        )
        self.con.commit()
        return cur.lastrowid

    def add_result(self, expr_id, proc_id, name, value) -> int:
        cur = self.con.execute(
            "INSERT INTO TblResults (ExprID, ProcessID, ResultName, "
            "ResultValue) VALUES (?,?,?,?)",
            (expr_id, proc_id, name, json.dumps(value)),
        )
        self.con.commit()
        return cur.lastrowid

    def end_process(self, proc_id: int, result_code: int = 0) -> None:
        self.con.execute(
            "UPDATE TblProcesses SET Finished=?, ResultCode=? "
            "WHERE ProcessID=?",
            (time.time(), result_code, proc_id),
        )
        self.con.commit()

    def log_run(self, subprocess: str, params: dict, results: dict,
                expr_name: str = "experiment") -> int:
        """One-shot convenience used by the CLI's -q flag."""
        eid = self.start_experiment(expr_name)
        pid = self.add_process(eid, subprocess)
        for k, v in params.items():
            self.add_parameter(eid, pid, k, v)
        for k, v in results.items():
            self.add_result(eid, pid, k, v)
        self.end_process(pid)
        return eid

    def close(self):
        self.con.close()
