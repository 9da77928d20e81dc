"""HTTP client stages of the PyTorch port (reference: io/http —
HTTPTransformer.scala:20-70 with its concurrency param,
SimpleHTTPTransformer.scala:15, Parsers.scala:28-155
JSONInputParser/JSONOutputParser/StringOutputParser/Custom*).

The port's own copy of ``mmlspark_tpu/io/http/transformer.py``, with the
same Params, fault site (``http.request``), span (``http/client``) and
retry policy. The JAX package sends through ``requests``; the port sends
through the standard library (``urllib.request``), which the card's
machine has: :func:`request` gives the same response dict, a 4xx or 5xx
answer included (``urllib`` raises those as ``HTTPError``; they are read
back as responses here, as ``requests`` returns them).
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ...core.dataframe import DataFrame
from ...core.params import (BooleanParam, ComplexParam, FloatParam,
                            HasInputCol, HasOutputCol, IntParam, StringParam)
from ...core.pipeline import Transformer
from ...core.utils import object_column
from ... import telemetry
from ...resilience import faults
from ...resilience.policy import RetryPolicy


class Response:
    """What one HTTP exchange answered: ``status_code``, ``text`` (the body
    decoded as UTF-8) and ``headers`` (a dict)."""

    __slots__ = ("status_code", "text", "headers")

    def __init__(self, status_code: int, body: bytes, headers):
        self.status_code = int(status_code)
        self.text = body.decode("utf-8", errors="replace")
        self.headers = dict(headers.items()) if headers is not None else {}


def request(method: str, url: str, data=None, headers=None,
            timeout: float = 30.0) -> Response:
    """One HTTP request through ``urllib``: every status answers a
    :class:`Response` (4xx and 5xx too); connection errors and timeouts
    raise (``URLError``/``OSError``, transient under the shared
    RetryPolicy)."""
    body = data.encode("utf-8") if isinstance(data, str) else data
    req = urllib.request.Request(url, data=body, headers=dict(headers or {}),
                                 method=method.upper())
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return Response(r.status, r.read(), r.headers)
    except urllib.error.HTTPError as e:
        try:
            return Response(e.code, e.read(), e.headers)
        finally:
            e.close()


# ------------------------------------------------------------------ parsers

class JSONInputParser(Transformer, HasInputCol, HasOutputCol):
    """Column value -> request dict with a JSON body (reference
    Parsers.scala JSONInputParser)."""
    url = StringParam("target url", default="")
    method = StringParam("HTTP method", default="POST")
    headers = ComplexParam("extra headers", default=None)

    def transform(self, df: DataFrame) -> DataFrame:
        col = df.col(self.getInputCol())
        out = []
        for v in col:
            body = v if isinstance(v, (dict, list)) else \
                json.loads(v) if isinstance(v, str) else \
                np.asarray(v).tolist()
            # json content type is always present; user headers merge on top
            # (reference Parsers.scala:52-53 appends it unconditionally)
            headers = {"Content-Type": "application/json"}
            headers.update(self.getHeaders() or {})
            out.append({"url": self.getUrl(), "method": self.getMethod(),
                        "headers": headers, "body": json.dumps(body)})
        return df.withColumn(self.getOutputCol(), object_column(out))


class CustomInputParser(Transformer, HasInputCol, HasOutputCol):
    udf = ComplexParam("value -> request dict", default=None)

    def transform(self, df: DataFrame) -> DataFrame:
        fn = self.getUdf()
        out = [fn(v) for v in df.col(self.getInputCol())]
        return df.withColumn(self.getOutputCol(), object_column(out))


class JSONOutputParser(Transformer, HasInputCol, HasOutputCol):
    """Response dict -> parsed JSON body (reference JSONOutputParser)."""

    def transform(self, df: DataFrame) -> DataFrame:
        out = []
        for r in df.col(self.getInputCol()):
            body = r.get("body") if isinstance(r, dict) else r
            if not body:
                out.append(None)
                continue
            try:
                out.append(json.loads(body))
            except (json.JSONDecodeError, TypeError):
                # one bad response (e.g. an HTML 504 page) must not lose the
                # whole batch
                out.append(None)
        return df.withColumn(self.getOutputCol(), object_column(out))


class StringOutputParser(Transformer, HasInputCol, HasOutputCol):
    def transform(self, df: DataFrame) -> DataFrame:
        out = [r.get("body") if isinstance(r, dict) else str(r)
               for r in df.col(self.getInputCol())]
        return df.withColumn(self.getOutputCol(), object_column(out))


class CustomOutputParser(Transformer, HasInputCol, HasOutputCol):
    udf = ComplexParam("response dict -> value", default=None)

    def transform(self, df: DataFrame) -> DataFrame:
        fn = self.getUdf()
        out = [fn(r) for r in df.col(self.getInputCol())]
        return df.withColumn(self.getOutputCol(), object_column(out))


# ------------------------------------------------------------------ clients

class HTTPTransformer(Transformer, HasInputCol, HasOutputCol):
    """Execute request dicts concurrently (reference HTTPTransformer.scala:20
    — async client with `concurrency`; Clients.scala:186-189).
    ``retries`` > 0 re-attempts transient per-row failures (connection
    errors, timeouts, 5xx/429 responses) through the shared RetryPolicy;
    the default 0 keeps the single-shot contract."""
    concurrency = IntParam("parallel in-flight requests", default=8, min=1)
    timeout = FloatParam("per-request timeout seconds", default=30.0)
    retries = IntParam("transient-failure retries per request (exponential "
                       "backoff, full jitter)", default=0, min=0)
    trace = BooleanParam(
        "propagate the current W3C traceparent on outgoing requests and "
        "record an http/client child span per row (no-op unless a "
        "distributed trace context is active)", default=True)

    def transform(self, df: DataFrame) -> DataFrame:
        reqs = df.col(self.getInputCol())
        policy = (RetryPolicy(name="http.transformer",
                              max_attempts=self.getRetries() + 1,
                              base_delay=0.1, max_delay=2.0)
                  if self.getRetries() else None)
        # the caller's trace context, captured HERE because the pool
        # threads below have their own (empty) thread-local context
        parent_ctx = (telemetry.context.current()
                      if self.getTrace() else None)

        def attempt(r: dict) -> dict:
            faults.inject("http.request")
            headers = r.get("headers")
            tp = telemetry.context.current_traceparent()
            if tp is not None:
                headers = dict(headers or {})
                headers.setdefault(telemetry.context.TRACEPARENT, tp)
            resp = request(r.get("method", "POST"), r["url"],
                           data=r.get("body"), headers=headers,
                           timeout=self.getTimeout())
            if policy is not None and (resp.status_code >= 500
                                       or resp.status_code == 429):
                err = IOError(f"HTTP {resp.status_code}")
                err.transient = True
                err.response = resp
                raise err
            return {"statusCode": resp.status_code, "body": resp.text,
                    "headers": resp.headers}

        def run(r: dict) -> dict:
            try:
                if parent_ctx is None:
                    if policy is None:
                        return attempt(r)
                    return policy.run(lambda _a: attempt(r))
                # each row is an http/client hop under the caller's trace;
                # the span's own context reaches the wire as traceparent
                with telemetry.context.use(parent_ctx), \
                        telemetry.trace.span("http/client",
                                             url=r.get("url", "")):
                    if policy is None:
                        return attempt(r)
                    return policy.run(lambda _a: attempt(r))
            except Exception as e:  # malformed request dicts (e.g. no
                # 'url') must fail their row, not the whole batch — same
                # per-row contract as a network error
                resp = getattr(e, "response", None)
                if resp is not None:   # retries exhausted on a 5xx: give
                    # the caller the real response, not an opaque error
                    return {"statusCode": resp.status_code,
                            "body": resp.text, "headers": resp.headers}
                return {"statusCode": 0, "body": None, "error": str(e)}

        with ThreadPoolExecutor(self.getConcurrency()) as pool:
            out = list(pool.map(run, reqs))
        return df.withColumn(self.getOutputCol(), object_column(out))


class SimpleHTTPTransformer(Transformer, HasInputCol, HasOutputCol):
    """JSONInputParser -> HTTPTransformer -> JSONOutputParser in one stage
    (reference SimpleHTTPTransformer.scala:15)."""
    url = StringParam("target url", default="")
    concurrency = IntParam("parallel in-flight requests", default=8, min=1)

    def transform(self, df: DataFrame) -> DataFrame:
        from ...core.schema import findUnusedColumnName
        tmp_req = findUnusedColumnName("__req", df)
        tmp_resp = findUnusedColumnName("__resp", df)
        out = (JSONInputParser().setInputCol(self.getInputCol())
               .setOutputCol(tmp_req).setUrl(self.getUrl()).transform(df))
        out = (HTTPTransformer().setInputCol(tmp_req).setOutputCol(tmp_resp)
               .setConcurrency(self.getConcurrency()).transform(out))
        out = (JSONOutputParser().setInputCol(tmp_resp)
               .setOutputCol(self.getOutputCol()).transform(out))
        return out.drop(tmp_req, tmp_resp)
