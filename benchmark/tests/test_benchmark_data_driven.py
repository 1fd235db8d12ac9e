"""The harness takes a new cell from files alone: a new traffic file, a new
workload entry and its limits, with no edit to the harness."""

import json

from benchmark import run
from conftest import ROOT


def test_a_new_traffic_file_runs(tmp_path):
    bench = json.load(open(f'{ROOT}/BENCHMARK.json'))
    bench['workloads'].append(dict(name='camera.mid', config='opt_camera',
                                   traffic='mid_chained', chips=1,
                                   why='tau 1e-2, two steps a block'))
    for m in bench['end_to_end']:
        if m['name'] == 'step_ms':
            m['workloads'].append('camera.mid')
    (tmp_path / 'mid_chained.json').write_text(json.dumps(dict(
        tau=1e-2, chain=2, restart=10, angles=[15, 35], trace_steps=2)))
    (tmp_path / 'camera.mid.json').write_text(json.dumps(dict(
        limits=dict(loss=1e-3, grad=0.1, change=0.1))))
    spec = run.load_spec('camera.mid', bench=bench,
                         dirs=dict(traffic=str(tmp_path),
                                   workloads=str(tmp_path)))
    spec['cfg'].update(batch_size=4, image_size=16)
    spec['cfg']['mesh']['level'] = 1
    result, info = run.run_cell(spec, 3, 0.2, 0, device='cpu')
    assert result['correct'], result['checks']
    assert set(result['metrics']) == {'step_ms', 'setup_s'}


def test_every_metric_has_a_reader_and_moves_what_its_cells_report():
    bench = json.load(open(f'{ROOT}/BENCHMARK.json'))
    for m in bench['end_to_end'] + bench['per_layer']:
        mod = run._module(f'{ROOT}/benchmark/metrics/{m["name"]}.py', 'm')
        assert callable(mod.read), m['name']
    for m in bench['per_layer']:
        for w in m['workloads']:
            reported = {e['name'] for e in run.load_spec(w, bench)
                        ['end_to_end']}
            assert m['moves'] in reported, (m['name'], w)
