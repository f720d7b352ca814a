"""Fingerprint a directory of audio files and find the best matches for
a query file.

Usage: python -m sonido_sonar_tpu_torch.examples.corpus_search query.wav corpus_dir/ [k]

decode_files_parallel -> FingerprintGenerator -> FingerprintComparator
.find_best_matches; `main` returns the matches, best first.
"""

import os
import sys

from sonido_sonar_tpu_torch.config.config import FeatureConfig, FingerprintConfig
from sonido_sonar_tpu_torch.fingerprint import FingerprintComparator, FingerprintGenerator
from sonido_sonar_tpu_torch.io.decode import Decoder, decode_files_parallel
from sonido_sonar_tpu_torch.utils.device import DEFAULT_DEVICE, Device


def main(query_path: str, corpus_dir: str, k: int = 5, device: Device = DEFAULT_DEVICE) -> list:
    paths = sorted(
        os.path.join(corpus_dir, f)
        for f in os.listdir(corpus_dir)
        if f.lower().endswith((".wav", ".mp3", ".flac", ".aac"))
    )
    print(f"decoding {len(paths)} files...")
    audios = decode_files_parallel(paths)

    gen = FingerprintGenerator(
        FingerprintConfig(feature_config=FeatureConfig(window_size=1024, hop_size=256)),
        device=device,
    )
    corpus = []
    for path, audio in zip(paths, audios):
        if audio is None:
            continue
        fp = gen.generate_fingerprint(audio)
        fp.stream_url = path
        corpus.append(fp)

    query = gen.generate_fingerprint(Decoder().decode_file(query_path))
    matches = FingerprintComparator(device=device).find_best_matches(query, corpus, max_results=k)
    print(f"\ntop {len(matches)} matches for {query_path}:")
    for m in matches:
        print(
            f"  #{m.rank} {m.fingerprint.stream_url} "
            f"sim={m.similarity.overall_similarity:.3f} "
            f"({m.similarity.match_type})"
        )
    return matches


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], int(sys.argv[3]) if len(sys.argv) > 3 else 5)
