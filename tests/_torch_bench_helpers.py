"""Shared by the port's harness tests: run a harness's ``main``, read the one-line JSON
document it prints last, and retry a run whose bars on the wall clock missed (and only
those bars)."""
import json


def run_main(main, argv, capsys):
    """``main(argv)``'s return code and its standard output."""
    capsys.readouterr()
    rc = main(list(argv))
    return rc, capsys.readouterr().out


def last_json(out):
    """The last line of ``out`` that parses as a JSON object."""
    for line in reversed(out.strip().splitlines()):
        line = line.strip()
        if line.startswith("{"):
            try:
                return json.loads(line)
            except ValueError:
                continue
    raise AssertionError("no JSON line in the output:\n%s" % out)


class WallClockBar(AssertionError):
    """A harness's bar on a wall-clock rate, share or window missed: the one failure a
    test retries (:func:`best_of_three`)."""


def wall_clock(call, bars):
    """``call()``'s result, with an ``AssertionError`` the harness raised whose message
    holds one of ``bars`` (fragments of its wall-clock bars' messages) raised again as a
    :class:`WallClockBar`. Every other failure (identity, row counts, leaks) stays what
    it is."""
    try:
        return call()
    except WallClockBar:
        raise
    except AssertionError as e:
        if any(bar in str(e) for bar in bars):
            raise WallClockBar(str(e)) from e
        raise


def missed_bars(failures, bars):
    """Check a harness's list of failures: those that name one of ``bars`` raise a
    :class:`WallClockBar`; any other fails the test at once."""
    timed = [f for f in failures if any(bar in f for bar in bars)]
    others = [f for f in failures if f not in timed]
    assert not others, others
    if timed:
        raise WallClockBar(timed)


def best_of_three(run):
    """``run()``'s result at its first attempt that raises no :class:`WallClockBar`: for
    a harness whose bars compare wall-clock rates or windows, which a host under the
    suite's parallel load can stall (the JAX package's timing-bound tests take the best
    of two windows for the same reason). Any other failure of an attempt fails the test
    at once: ``run`` asserts what no load can change on every attempt."""
    errors = []
    for _attempt in range(3):
        try:
            return run()
        except WallClockBar as e:
            errors.append(e)
    raise AssertionError("a wall-clock bar missed in three attempts: %s" % errors)
