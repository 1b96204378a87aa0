from .oracle import OracleScene, nif_forward, oracle_scene_from, trace_sample_oracle, render_oracle
