#!/bin/bash
# Builds the reference-vector dumper against the read-only reference mount.
# The resulting binary drives the srsRAN generic LDPC encoder/decoder so the
# rebuild can be cross-validated bit-for-bit (tools/ref_crossval/generate.py).
set -e
REF=${REF:-/root/reference}
OUT=${OUT:-/tmp/refbuild}
mkdir -p "$OUT"
INC="-I$REF/include -I$REF/lib/phy/upper/channel_coding/ldpc -I$REF/external/fmt/include -DFMT_HEADER_ONLY"
cd "$OUT"
for f in \
  $REF/lib/phy/upper/channel_coding/ldpc/ldpc_encoder_generic.cpp \
  $REF/lib/phy/upper/channel_coding/ldpc/ldpc_encoder_impl.cpp \
  $REF/lib/phy/upper/channel_coding/ldpc/ldpc_decoder_generic.cpp \
  $REF/lib/phy/upper/channel_coding/ldpc/ldpc_decoder_impl.cpp \
  $REF/lib/phy/upper/channel_coding/ldpc/ldpc_graph_impl.cpp \
  $REF/lib/phy/upper/channel_coding/ldpc/ldpc_luts_impl.cpp \
  $REF/lib/phy/upper/log_likelihood_ratio.cpp \
  $REF/lib/srsvec/bit.cpp $REF/lib/srsvec/dot_prod.cpp $REF/lib/srsvec/compare.cpp; do
  g++ -O2 -std=c++17 $INC -c "$f" -o "$(basename "$f" .cpp).o"
done
g++ -O2 -std=c++17 $INC -c "$(dirname "$0")/dump_vectors.cpp" -o dump.o
g++ -o dump dump.o ldpc_encoder_generic.o ldpc_encoder_impl.o ldpc_decoder_generic.o \
  ldpc_decoder_impl.o ldpc_graph_impl.o ldpc_luts_impl.o log_likelihood_ratio.o \
  bit.o dot_prod.o compare.o
echo "built $OUT/dump"

# UL-SCH demultiplexer + ulsch_info cross-validation dumper.
UINC="$INC -I$REF/lib/phy/upper/channel_processors/pusch"
for f in \
  $REF/lib/phy/upper/channel_processors/pusch/ulsch_demultiplex_impl.cpp \
  $REF/lib/ran/pusch/ulsch_info.cpp \
  $REF/lib/ran/sch/sch_segmentation.cpp; do
  g++ -O2 -std=c++17 $UINC -c "$f" -o "$(basename "$f" .cpp).o"
done
g++ -O2 -std=c++17 $UINC -c "$(dirname "$0")/dump_ulsch.cpp" -o dump_ulsch.o
g++ -o dump_ulsch dump_ulsch.o ulsch_demultiplex_impl.o ulsch_info.o \
  sch_segmentation.o log_likelihood_ratio.o bit.o compare.o
echo "built $OUT/dump_ulsch"

# Polar chain cross-validation dumper.
PINC="$INC -I$REF/lib/phy/upper/channel_coding/polar"
for f in \
  $REF/lib/phy/upper/channel_coding/polar/polar_code_impl.cpp \
  $REF/lib/phy/upper/channel_coding/polar/polar_allocator_impl.cpp \
  $REF/lib/phy/upper/channel_coding/polar/polar_deallocator_impl.cpp \
  $REF/lib/phy/upper/channel_coding/polar/polar_decoder_impl.cpp \
  $REF/lib/phy/upper/channel_coding/polar/polar_encoder_impl.cpp \
  $REF/lib/phy/upper/channel_coding/polar/polar_interleaver_impl.cpp \
  $REF/lib/phy/upper/channel_coding/polar/polar_rate_dematcher_impl.cpp \
  $REF/lib/phy/upper/channel_coding/polar/polar_rate_matcher_impl.cpp; do
  g++ -O2 -std=c++17 $PINC -c "$f" -o "$(basename "$f" .cpp).o"
done
g++ -O2 -std=c++17 $PINC -c "$(dirname "$0")/dump_polar.cpp" -o dump_polar.o
g++ -O2 -std=c++17 $INC -c $REF/lib/srsvec/aligned_vec.cpp -o aligned_vec.o
g++ -o dump_polar dump_polar.o polar_code_impl.o polar_allocator_impl.o \
  polar_deallocator_impl.o polar_decoder_impl.o polar_encoder_impl.o \
  polar_interleaver_impl.o polar_rate_dematcher_impl.o polar_rate_matcher_impl.o \
  log_likelihood_ratio.o bit.o compare.o aligned_vec.o
echo "built $OUT/dump_polar"

# Interval-table demapper cross-validation dumper.
MINC="$INC -I$REF/lib/phy/upper/channel_modulation"
for f in \
  $REF/lib/phy/upper/channel_modulation/demodulation_mapper_impl.cpp \
  $REF/lib/phy/upper/channel_modulation/demodulation_mapper_qpsk.cpp \
  $REF/lib/phy/upper/channel_modulation/demodulation_mapper_qam16.cpp \
  $REF/lib/phy/upper/channel_modulation/demodulation_mapper_qam64.cpp \
  $REF/lib/phy/upper/channel_modulation/demodulation_mapper_qam256.cpp; do
  g++ -O2 -std=c++17 $MINC -c "$f" -o "$(basename "$f" .cpp).o"
done
g++ -O2 -std=c++17 $MINC -c "$(dirname "$0")/dump_demap.cpp" -o dump_demap.o
g++ -o dump_demap dump_demap.o demodulation_mapper_impl.o \
  demodulation_mapper_qpsk.o demodulation_mapper_qam16.o \
  demodulation_mapper_qam64.o demodulation_mapper_qam256.o \
  log_likelihood_ratio.o bit.o compare.o
echo "built $OUT/dump_demap"

# PRACH detector cross-validation dumper.
RINC="$INC -I$REF/lib/phy/upper/channel_processors -I$REF/lib/phy/generic_functions"
for f in \
  $REF/lib/phy/upper/channel_processors/prach_detector_generic_impl.cpp \
  $REF/lib/phy/upper/channel_processors/prach_generator_impl.cpp \
  $REF/lib/phy/generic_functions/dft_processor_generic_impl.cpp \
  $REF/lib/ran/prach/prach_cyclic_shifts.cpp \
  $REF/lib/ran/prach/prach_preamble_information.cpp \
  $REF/lib/srsvec/accumulate.cpp $REF/lib/srsvec/add.cpp \
  $REF/lib/srsvec/division.cpp $REF/lib/srsvec/modulus_square.cpp \
  $REF/lib/srsvec/prod.cpp $REF/lib/srsvec/sc_prod.cpp; do
  g++ -O2 -std=c++17 $RINC -c "$f" -o "$(basename "$f" .cpp).o"
done
g++ -O2 -std=c++17 $RINC -c "$(dirname "$0")/dump_prach.cpp" -o dump_prach.o
g++ -o dump_prach dump_prach.o prach_detector_generic_impl.o prach_generator_impl.o \
  dft_processor_generic_impl.o prach_cyclic_shifts.o prach_preamble_information.o \
  accumulate.o add.o division.o modulus_square.o prod.o sc_prod.o \
  log_likelihood_ratio.o bit.o compare.o dot_prod.o aligned_vec.o
echo "built $OUT/dump_prach"

# Modulation mapper cross-validation dumper.
g++ -O2 -std=c++17 $MINC -c $REF/lib/phy/upper/channel_modulation/modulation_mapper_lut_impl.cpp -o modulation_mapper_lut_impl.o
g++ -O2 -std=c++17 $INC -c $REF/lib/srsvec/sc_prod.cpp -o sc_prod.o
g++ -O2 -std=c++17 $MINC -c "$(dirname "$0")/dump_mod.cpp" -o dump_mod.o
g++ -o dump_mod dump_mod.o modulation_mapper_lut_impl.o \
  log_likelihood_ratio.o bit.o compare.o dot_prod.o sc_prod.o aligned_vec.o
echo "built $OUT/dump_mod"

# Channel equalizer cross-validation dumper.
EINC="$INC -I$REF/lib/phy/upper/equalization"
g++ -O2 -std=c++17 $EINC -c $REF/lib/phy/upper/equalization/channel_equalizer_generic_impl.cpp -o channel_equalizer_generic_impl.o
g++ -O2 -std=c++17 $EINC -c "$(dirname "$0")/dump_eq.cpp" -o dump_eq.o
g++ -o dump_eq dump_eq.o channel_equalizer_generic_impl.o \
  log_likelihood_ratio.o bit.o compare.o dot_prod.o sc_prod.o aligned_vec.o
echo "built $OUT/dump_eq"

# Channel-estimator cross-validation dumper (port_channel_estimator_average_impl).
CINC="$INC -I$REF/lib/phy/upper/signal_processors -I$REF/lib/phy/support -I$REF/lib/phy/generic_functions"
for f in \
  $REF/lib/phy/upper/signal_processors/port_channel_estimator_average_impl.cpp \
  $REF/lib/phy/support/interpolator/interpolator_linear_impl.cpp \
  $REF/lib/phy/support/time_alignment_estimator/time_alignment_estimator_dft_impl.cpp \
  $REF/lib/srsvec/conversion.cpp $REF/lib/srsvec/convolution.cpp \
  $REF/lib/srsvec/unwrap.cpp $REF/lib/srsvec/subtract.cpp; do
  g++ -O2 -std=c++17 $CINC -c "$f" -o "$(basename "$f" .cpp).o"
done
g++ -O2 -std=c++17 $CINC -c "$(dirname "$0")/dump_est.cpp" -o dump_est.o
g++ -o dump_est dump_est.o port_channel_estimator_average_impl.o \
  interpolator_linear_impl.o time_alignment_estimator_dft_impl.o \
  dft_processor_generic_impl.o conversion.o convolution.o unwrap.o subtract.o \
  accumulate.o add.o prod.o sc_prod.o dot_prod.o compare.o bit.o \
  modulus_square.o aligned_vec.o log_likelihood_ratio.o
echo "built $OUT/dump_est"

# OFDM modulator/demodulator cross-validation dumper.
OINC="$INC -I$REF/lib/phy/lower/modulation -I$REF/lib/phy/generic_functions"
for f in \
  $REF/lib/phy/lower/modulation/ofdm_modulator_impl.cpp \
  $REF/lib/phy/lower/modulation/ofdm_demodulator_impl.cpp; do
  g++ -O2 -std=c++17 $OINC -c "$f" -o "$(basename "$f" .cpp).o"
done
g++ -O2 -std=c++17 $OINC -c "$(dirname "$0")/dump_ofdm.cpp" -o dump_ofdm.o
g++ -o dump_ofdm dump_ofdm.o ofdm_modulator_impl.o ofdm_demodulator_impl.o \
  dft_processor_generic_impl.o conversion.o sc_prod.o prod.o add.o dot_prod.o \
  compare.o bit.o accumulate.o modulus_square.o aligned_vec.o log_likelihood_ratio.o
echo "built $OUT/dump_ofdm"

# Short-block encoder/detector cross-validation dumper.
SINC="$INC -I$REF/lib/phy/upper/channel_coding/short"
for f in \
  $REF/lib/phy/upper/channel_coding/short/short_block_encoder_impl.cpp \
  $REF/lib/phy/upper/channel_coding/short/short_block_detector_impl.cpp; do
  g++ -O2 -std=c++17 $SINC -c "$f" -o "$(basename "$f" .cpp).o"
done
g++ -O2 -std=c++17 $SINC -c "$(dirname "$0")/dump_short.cpp" -o dump_short.o
g++ -o dump_short dump_short.o short_block_encoder_impl.o \
  short_block_detector_impl.o log_likelihood_ratio.o bit.o dot_prod.o \
  compare.o accumulate.o aligned_vec.o
echo "built $OUT/dump_short"

# Gold PRG + low-PAPR sequence cross-validation dumper.
QINC="$INC -I$REF/external -I$REF/lib/phy/upper/sequence_generators"
for f in \
  $REF/lib/phy/upper/sequence_generators/pseudo_random_generator_impl.cpp \
  $REF/lib/phy/upper/sequence_generators/low_papr_sequence_generator_impl.cpp \
  $REF/lib/support/math_utils.cpp; do
  g++ -O2 -std=c++17 $QINC -c "$f" -o "$(basename "$f" .cpp).o"
done
g++ -O2 -std=c++17 $QINC -c "$(dirname "$0")/dump_seq.cpp" -o dump_seq.o
g++ -o dump_seq dump_seq.o pseudo_random_generator_impl.o \
  low_papr_sequence_generator_impl.o math_utils.o log_likelihood_ratio.o \
  bit.o dot_prod.o compare.o accumulate.o sc_prod.o prod.o aligned_vec.o
echo "built $OUT/dump_seq"

# PSS/SSS cross-validation dumper.
BINC="$INC -I$REF/external -I$REF/lib/phy/upper/signal_processors"
for f in \
  $REF/lib/phy/upper/signal_processors/pss_processor_impl.cpp \
  $REF/lib/phy/upper/signal_processors/sss_processor_impl.cpp; do
  g++ -O2 -std=c++17 $BINC -c "$f" -o "$(basename "$f" .cpp).o"
done
g++ -O2 -std=c++17 $BINC -c "$(dirname "$0")/dump_ssb.cpp" -o dump_ssb.o
g++ -o dump_ssb dump_ssb.o pss_processor_impl.o sss_processor_impl.o prod.o \
  sc_prod.o compare.o bit.o dot_prod.o accumulate.o aligned_vec.o \
  log_likelihood_ratio.o
echo "built $OUT/dump_ssb"

# PUCCH format-0 detector cross-validation dumper.
PUINC="$INC -I$REF/external -I$REF/lib/phy/upper/channel_processors -I$REF/lib/phy/upper/sequence_generators -I$REF/lib/phy/upper/signal_processors/pucch -I$REF/lib/phy/upper/signal_processors"
g++ -O2 -std=c++17 $PUINC -c $REF/lib/phy/upper/channel_processors/pucch_detector_format0.cpp -o pucch_detector_format0.o
g++ -O2 -std=c++17 $PUINC -c $REF/lib/phy/upper/sequence_generators/low_papr_sequence_collection_impl.cpp -o low_papr_sequence_collection_impl.o
g++ -O2 -std=c++17 $PUINC -c "$(dirname "$0")/dump_pucch0.cpp" -o dump_pucch0.o
g++ -o dump_pucch0 dump_pucch0.o pucch_detector_format0.o \
  low_papr_sequence_collection_impl.o low_papr_sequence_generator_impl.o \
  pseudo_random_generator_impl.o math_utils.o prod.o sc_prod.o compare.o \
  bit.o dot_prod.o accumulate.o aligned_vec.o log_likelihood_ratio.o \
  modulus_square.o
echo "built $OUT/dump_pucch0"

# DM-RS sequence cross-validation dumper.
DINC="$INC -I$REF/external -I$REF/lib/phy/upper/signal_processors -I$REF/lib/phy/upper/sequence_generators"
g++ -O2 -std=c++17 $DINC -c "$(dirname "$0")/dump_dmrs.cpp" -o dump_dmrs.o
g++ -o dump_dmrs dump_dmrs.o pseudo_random_generator_impl.o \
  log_likelihood_ratio.o bit.o compare.o dot_prod.o accumulate.o aligned_vec.o
echo "built $OUT/dump_dmrs"

# PUCCH format-1 detector + format-2 demodulator cross-validation dumpers.
P1INC="$INC -I$REF/external -I$REF/lib/phy/upper/channel_processors -I$REF/lib/phy/upper/sequence_generators -I$REF/lib/phy/upper/signal_processors/pucch -I$REF/lib/phy/upper/signal_processors -I$REF/lib/phy/upper/equalization -I$REF/lib/phy/upper/channel_modulation -I$REF/lib/phy/upper/channel_coding/short"
g++ -O2 -std=c++17 $P1INC -c $REF/lib/phy/upper/channel_processors/pucch_detector_impl.cpp -o pucch_detector_impl.o
g++ -O2 -std=c++17 $P1INC -c $REF/lib/phy/upper/channel_processors/pucch_demodulator_impl.cpp -o pucch_demodulator_impl.o
g++ -O2 -std=c++17 $P1INC -c "$(dirname "$0")/dump_pucch1.cpp" -o dump_pucch1.o
g++ -o dump_pucch1 dump_pucch1.o pucch_detector_impl.o pucch_detector_format0.o \
  low_papr_sequence_collection_impl.o low_papr_sequence_generator_impl.o \
  pseudo_random_generator_impl.o channel_equalizer_generic_impl.o math_utils.o \
  prod.o sc_prod.o compare.o bit.o dot_prod.o accumulate.o aligned_vec.o \
  log_likelihood_ratio.o modulus_square.o conversion.o add.o subtract.o
g++ -O2 -std=c++17 $P1INC -c "$(dirname "$0")/dump_pucch2.cpp" -o dump_pucch2.o
g++ -o dump_pucch2 dump_pucch2.o pucch_demodulator_impl.o \
  channel_equalizer_generic_impl.o demodulation_mapper_impl.o \
  demodulation_mapper_qpsk.o demodulation_mapper_qam16.o \
  demodulation_mapper_qam64.o demodulation_mapper_qam256.o \
  pseudo_random_generator_impl.o short_block_detector_impl.o \
  short_block_encoder_impl.o math_utils.o prod.o sc_prod.o compare.o bit.o \
  dot_prod.o accumulate.o aligned_vec.o log_likelihood_ratio.o \
  modulus_square.o conversion.o add.o subtract.o
echo "built $OUT/dump_pucch1 $OUT/dump_pucch2"

# PBCH encoder cross-validation dumper.
PBINC="$INC -I$REF/external -I$REF/lib/phy/upper/channel_processors -I$REF/lib/phy/upper/channel_coding -I$REF/lib/phy/upper/channel_coding/polar -I$REF/lib/phy/upper/sequence_generators"
g++ -O2 -std=c++17 $PBINC -c $REF/lib/phy/upper/channel_coding/crc_calculator_lut_impl.cpp -o crc_calculator_lut_impl.o
g++ -O2 -std=c++17 $PBINC -c $REF/lib/phy/upper/channel_processors/pbch_encoder_impl.cpp -o pbch_encoder_impl.o
g++ -O2 -std=c++17 $PBINC -c "$(dirname "$0")/dump_pbch.cpp" -o dump_pbch.o
g++ -o dump_pbch dump_pbch.o pbch_encoder_impl.o crc_calculator_lut_impl.o \
  polar_allocator_impl.o polar_code_impl.o polar_encoder_impl.o \
  polar_interleaver_impl.o polar_rate_matcher_impl.o \
  pseudo_random_generator_impl.o log_likelihood_ratio.o bit.o compare.o \
  dot_prod.o accumulate.o aligned_vec.o
echo "built $OUT/dump_pbch"

# PDCCH encoder cross-validation dumper.
g++ -O2 -std=c++17 $PBINC -c $REF/lib/phy/upper/channel_processors/pdcch_encoder_impl.cpp -o pdcch_encoder_impl.o
g++ -O2 -std=c++17 $PBINC -c "$(dirname "$0")/dump_pdcch.cpp" -o dump_pdcch.o
g++ -o dump_pdcch dump_pdcch.o pdcch_encoder_impl.o crc_calculator_lut_impl.o \
  polar_allocator_impl.o polar_code_impl.o polar_encoder_impl.o \
  polar_interleaver_impl.o polar_rate_matcher_impl.o log_likelihood_ratio.o \
  bit.o compare.o dot_prod.o accumulate.o aligned_vec.o
echo "built $OUT/dump_pdcch"
