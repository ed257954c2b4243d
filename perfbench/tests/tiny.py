"""Small sizes at which the tests run a cell on the CPU."""

# at this size 30 kbit/s gives about the bits a sample of 4500 at 1080p
LIVE = {"params": {"source_width": 128, "source_height": 96, "bitrate": 30,
                   "vbv_max_bitrate": 30, "vbv_buffer_size": 30},
        "traffic": {"pool_frames": 90, "segment_frames": 10,
                    "warmup_frames": 8, "check_pictures": 3}}

# a cell with shot cuts and scene-cut detection, which the tests add to a
# copy of the benchmark as files and entries only: x265's medium preset at
# CRF 28, film-like shots
VOD_CONFIG = {
    "name": "x265-medium-test", "preset": "medium", "tune": None,
    "params": {"source_width": 1920, "source_height": 1080, "fps_num": 24,
               "fps_denom": 1, "rc_mode": 1, "crf": 28.0,
               "decoded_picture_hash": 1},
    "reduced": []}
VOD_TRAFFIC = {
    "pool_frames": 336, "shot_frames": [72, 120, 144],
    "segment_frames": None, "pan_px": [0, 8], "objects": [2, 6],
    "object_px": [0, 16], "noise": 2, "warmup_frames": 48,
    "check_pictures": 3, "check_k1_calls": 4, "check_k2_calls": 2}
VOD = {"params": {"source_width": 128, "source_height": 96},
       "traffic": {"pool_frames": 90, "shot_frames": [30, 36, 24],
                   "warmup_frames": 30, "check_pictures": 3}}

# the GOP-parallel cell: 2 channels' closed GOPs of 8 frames, a cut
# inside each; the height is padded to the coded 96, as 1080 is to 1088
CHANNELS = {"config": {"gops": 2},
            "params": {"source_width": 128, "source_height": 88,
                       "keyint_max": 8, "keyint_min": 8},
            "traffic": {"shot_frames": [5, 7], "check_pictures": 3}}
CELLS = {"ultrafast-1080p.live": LIVE,
         "medium-zerolatency-1080p.ch8": CHANNELS}
