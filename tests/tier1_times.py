"""Where a tier-1 run's time went, from its junit XML and its log.

Run tier-1 as ROADMAP.md's "Tier-1 verify" line gives it, with
``--durations=0`` added (and ``-v`` in place of ``-q`` for the workers),
then:

    python tests/tier1_times.py <junit.xml> [<log>] [--slowest 25]

It prints the suite's counts, each file's total (the sum of junit's
per-test times, setup and teardown included), its tests, passes and skips,
the xdist worker that ran it (from the log's ``[gwN]`` lines under ``-v``),
each worker's sum, and the slowest phases from the ``--durations`` table.
Under ``--dist loadfile`` a file is one worker's job, so the longest
worker sets the wall time.  Port test files (``tests/test_torch_*.py``)
over ``CEILING`` seconds are flagged.
"""

import argparse
import collections
import re
import sys
import xml.etree.ElementTree as ET

CEILING = 180.0


def file_totals(xml_path):
    """{file: (seconds, tests, passed, skipped, failed)} from a junit
    XML, and the suite's attributes."""
    root = ET.parse(xml_path).getroot()
    suite = root.find('testsuite') if root.tag == 'testsuites' else root
    totals = collections.defaultdict(lambda: [0.0, 0, 0, 0, 0])
    for case in root.iter('testcase'):
        name = case.get('file') or \
            'tests/' + case.get('classname').split('.')[1] + '.py'
        row = totals[name]
        row[0] += float(case.get('time') or 0.0)
        row[1] += 1
        kinds = {child.tag for child in case}
        if kinds & {'failure', 'error'}:
            row[4] += 1
        elif 'skipped' in kinds:
            row[3] += 1
        else:
            row[2] += 1
    return {k: tuple(v) for k, v in totals.items()}, dict(suite.attrib)


def workers(log_text):
    """{file: sorted xdist workers} from a -v log's result lines."""
    seen = collections.defaultdict(set)
    for m in re.finditer(r'\[(gw\d+)\] \[\s*\d+%\] \w+ (tests/[\w/]+\.py)',
                         log_text):
        seen[m.group(2)].add(m.group(1))
    return {k: sorted(v) for k, v in seen.items()}


def slowest(log_text, n):
    m = re.search(r'=+ slowest durations =+\n(.*?)\n\n', log_text, re.S)
    return m.group(1).splitlines()[:n] if m else []


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('xml')
    p.add_argument('log', nargs='?')
    p.add_argument('--slowest', type=int, default=25)
    args = p.parse_args(argv)
    totals, suite = file_totals(args.xml)
    text = open(args.log, errors='replace').read() if args.log else ''
    by_file = workers(text)
    print('suite: ' + ', '.join(f'{k}={suite.get(k)}' for k in
                                ('tests', 'errors', 'failures', 'skipped',
                                 'time')))
    per_worker = collections.Counter()
    over = []
    print(f'{"seconds":>9} {"tests":>5} {"pass":>5} {"skip":>5} '
          f'{"fail":>4}  worker  file')
    for name, (secs, n, ok, skip, bad) in sorted(
            totals.items(), key=lambda kv: -kv[1][0]):
        who = ','.join(by_file.get(name, ['?']))
        per_worker[who] += secs
        flag = ''
        if '/test_torch_' in name and secs > CEILING:
            flag = f'  over {CEILING:g} s'
            over.append(name)
        print(f'{secs:9.1f} {n:5d} {ok:5d} {skip:5d} {bad:4d}  {who:6s}  '
              f'{name}{flag}')
    if by_file:
        print('per worker: ' + ', '.join(
            f'{w} {s:.1f} s' for w, s in sorted(per_worker.items())))
    for line in slowest(text, args.slowest):
        print(line)
    return 1 if over else 0


if __name__ == '__main__':
    sys.exit(main())
