"""Copy of biokanga_tpu/utils/sqlite_summaries.py: SQLite experiment
tracking and results loaders.

Parity roles:
- SQLiteSummaries: every subprocess can log experiment, process,
  parameters and summary results (CSQLiteSummaries::StartExperiment/
  AddProcess/AddParameter/AddResult, biokanga/SQLiteSummaries.cpp:
  600,719,1057; keyed by the gExperimentID/gProcessID globals,
  biokanga.cpp:134-137; enabled per subprocess with -q/--sumrslts)
- snps2sqlite / snpm2sqlite: SNP/marker CSVs -> the reference's
  7-table schema (Docs/biokanga.sql.schema.txt: TblExprs, TblCults,
  TblSeqs, TblLoci, TblSnps, TblMarkers, TblMarkerSnps)
- de2sqlite / psl2sqlite: DE CSV / blitz PSL -> SQLite (CSQLiteDE /
  CSQLitePSL roles)

Python stdlib sqlite3 replaces the vendored sqlite3.c.
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


def snps_to_sqlite(db_path: str, snp_csv: str, expr_name: str,
                   cult_name: str = "cultivar") -> int:
    """SNP CSV (reference layout) -> the reference marker/SNP schema
    (snps2sqlite role). Returns the number of SNP rows loaded."""
    import csv as _csv

    con = sqlite3.connect(db_path)
    con.executescript(
        """
        CREATE TABLE IF NOT EXISTS TblExprs (
          ExprID INTEGER PRIMARY KEY ASC, ExprType INTEGER,
          ExprInFile TEXT, ExprName TEXT, ExprDescr TEXT, CultName TEXT);
        CREATE TABLE IF NOT EXISTS TblCults (
          CultID INTEGER PRIMARY KEY ASC, CultName TEXT UNIQUE);
        CREATE TABLE IF NOT EXISTS TblSeqs (
          SeqID INTEGER PRIMARY KEY ASC, ExprID INTEGER, SeqName TEXT);
        CREATE TABLE IF NOT EXISTS TblLoci (
          LociID INTEGER PRIMARY KEY ASC, ExprID INTEGER, SeqID INTEGER,
          Offset INTEGER, Base TEXT);
        CREATE TABLE IF NOT EXISTS TblSnps (
          SnpID INTEGER PRIMARY KEY ASC, ExprID INTEGER, CultID INTEGER,
          LociID INTEGER, Acnt INTEGER DEFAULT 0, Ccnt INTEGER DEFAULT 0,
          Gcnt INTEGER DEFAULT 0, Tcnt INTEGER DEFAULT 0,
          Ncnt INTEGER DEFAULT 0, TotCovCnt INTEGER, TotMMCnt INTEGER,
          PValue REAL, Rank INTEGER);
        CREATE TABLE IF NOT EXISTS TblMarkers (
          MarkerID INTEGER PRIMARY KEY ASC, ExprID INTEGER, LociID INTEGER,
          CultID INTEGER, Base TEXT, Score INTEGER);
        CREATE TABLE IF NOT EXISTS TblMarkerSnps (
          MarkerSnpID INTEGER PRIMARY KEY ASC, MarkerID INTEGER,
          SnpID INTEGER);
        """
    )
    cur = con.execute(
        "INSERT INTO TblExprs (ExprType, ExprInFile, ExprName, CultName) "
        "VALUES (1,?,?,?)",
        (snp_csv, expr_name, cult_name),
    )
    eid = cur.lastrowid
    con.execute("INSERT OR IGNORE INTO TblCults (CultName) VALUES (?)",
                (cult_name,))
    cult_id = con.execute(
        "SELECT CultID FROM TblCults WHERE CultName=?", (cult_name,)
    ).fetchone()[0]

    seq_ids: dict[str, int] = {}
    n = 0
    with open(snp_csv) as f:
        rd = _csv.reader(f)
        header = next(rd)
        col = {c: i for i, c in enumerate(header)}
        for r in rd:
            chrom = r[col["Chrom"]]
            if chrom not in seq_ids:
                c2 = con.execute(
                    "INSERT INTO TblSeqs (ExprID, SeqName) VALUES (?,?)",
                    (eid, chrom),
                )
                seq_ids[chrom] = c2.lastrowid
            c3 = con.execute(
                "INSERT INTO TblLoci (ExprID, SeqID, Offset, Base) "
                "VALUES (?,?,?,?)",
                (eid, seq_ids[chrom], int(r[col["StartLoci"]]),
                 r[col["RefBase"]]),
            )
            con.execute(
                "INSERT INTO TblSnps (ExprID, CultID, LociID, Acnt, Ccnt, "
                "Gcnt, Tcnt, Ncnt, TotCovCnt, TotMMCnt, PValue, Rank) "
                "VALUES (?,?,?,?,?,?,?,?,?,?,?,?)",
                (eid, cult_id, c3.lastrowid,
                 int(r[col["MMBaseA"]]), int(r[col["MMBaseC"]]),
                 int(r[col["MMBaseG"]]), int(r[col["MMBaseT"]]),
                 int(r[col["MMBaseN"]]), int(r[col["Bases"]]),
                 int(r[col["Mismatches"]]), float(r[col["PValue"]]),
                 int(r[col["Rank"]])),
            )
            n += 1
    con.commit()
    con.close()
    return n


def psl_to_sqlite(db_path: str, psl_path: str, expr_name: str) -> int:
    """Blitz PSL -> SQLite (psl2sqlite / CSQLitePSL role)."""
    con = sqlite3.connect(db_path)
    con.executescript(
        """
        CREATE TABLE IF NOT EXISTS TblExprs (
          ExprID INTEGER PRIMARY KEY ASC, ExprName TEXT, ExprInFile TEXT);
        CREATE TABLE IF NOT EXISTS TblAlignments (
          AlignID INTEGER PRIMARY KEY ASC, ExprID INTEGER,
          Matches INTEGER, MisMatches INTEGER, RepMatches INTEGER,
          NCount INTEGER, QNumInserts INTEGER, QBaseInserts INTEGER,
          TNumInserts INTEGER, TBaseInserts INTEGER, Strand TEXT,
          QName TEXT, QSize INTEGER, QStart INTEGER, QEnd INTEGER,
          TName TEXT, TSize INTEGER, TStart INTEGER, TEnd INTEGER,
          BlockCount INTEGER, BlockSizes TEXT, QStarts TEXT, TStarts TEXT);
        """
    )
    cur = con.execute(
        "INSERT INTO TblExprs (ExprName, ExprInFile) VALUES (?,?)",
        (expr_name, psl_path),
    )
    eid = cur.lastrowid
    n = 0
    with open(psl_path) as f:
        for line in f:
            fl = line.rstrip("\n").split("\t")
            if len(fl) != 21 or not fl[0].isdigit():
                continue
            con.execute(
                "INSERT INTO TblAlignments (ExprID, Matches, MisMatches, "
                "RepMatches, NCount, QNumInserts, QBaseInserts, TNumInserts,"
                " TBaseInserts, Strand, QName, QSize, QStart, QEnd, TName, "
                "TSize, TStart, TEnd, BlockCount, BlockSizes, QStarts, "
                "TStarts) VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,"
                "?,?)",
                (eid, *[int(x) for x in fl[:8]], fl[8], fl[9], int(fl[10]),
                 int(fl[11]), int(fl[12]), fl[13], int(fl[14]), int(fl[15]),
                 int(fl[16]), int(fl[17]), fl[18], fl[19], fl[20]),
            )
            n += 1
    con.commit()
    con.close()
    return n


def de_to_sqlite(db_path: str, de_csv: str, expr_name: str) -> int:
    """rnade CSV -> SQLite (de2sqlite / CSQLiteDE role)."""
    import csv as _csv

    con = sqlite3.connect(db_path)
    con.executescript(
        """
        CREATE TABLE IF NOT EXISTS TblExprs (
          ExprID INTEGER PRIMARY KEY ASC, ExprName TEXT, ExprInFile TEXT);
        CREATE TABLE IF NOT EXISTS TblDE (
          DEID INTEGER PRIMARY KEY ASC, ExprID INTEGER, Feature TEXT,
          CtrlCnts REAL, ExprCnts REAL, FoldChange REAL, Pearson REAL,
          Class TEXT);
        """
    )
    cur = con.execute(
        "INSERT INTO TblExprs (ExprName, ExprInFile) VALUES (?,?)",
        (expr_name, de_csv),
    )
    eid = cur.lastrowid
    n = 0
    with open(de_csv) as f:
        rd = _csv.reader(f)
        next(rd)
        for r in rd:
            con.execute(
                "INSERT INTO TblDE (ExprID, Feature, CtrlCnts, ExprCnts, "
                "FoldChange, Pearson, Class) VALUES (?,?,?,?,?,?,?)",
                (eid, r[0], float(r[1]), float(r[2]), float(r[3]),
                 float(r[4]), r[5]),
            )
            n += 1
    con.commit()
    con.close()
    return n
