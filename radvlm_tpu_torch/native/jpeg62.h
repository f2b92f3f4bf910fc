// The part of libjpeg's 6.2 ABI (IJG `jpeglib.h` at JPEG_LIB_VERSION 62,
// as libjpeg-turbo ships it) that jpeg.cc uses: the decompressor's struct
// laid out field for field, the error manager, and the entry points.
//
// jpeg.cc links against the libjpeg that PIL itself loads (Pillow's wheels
// carry libjpeg-turbo built at this ABI), so the port needs no libjpeg
// headers or development package on the host: a machine that has PIL and
// a C++ compiler builds the decoder, and its pixels are PIL's.
//
// The declarations follow jpeglib.h, which was part of the Independent JPEG
// Group's software: Copyright (C) 1991-1998, Thomas G. Lane. Modified
// 2002-2009 by Guido Vollbeding. libjpeg-turbo Modifications: Copyright (C)
// 2009-2011, 2013-2014, 2016-2017, 2020, D. R. Commander; Copyright (C)
// 2015, Google, Inc. For conditions of distribution and use, see the IJG
// README (README.ijg) that libjpeg and libjpeg-turbo ship.

#pragma once

#include <cstddef>
#include <cstdio>

extern "C" {

typedef unsigned char JSAMPLE;
typedef JSAMPLE* JSAMPROW;
typedef JSAMPROW* JSAMPARRAY;
typedef unsigned int JDIMENSION;
typedef unsigned char UINT8;
typedef unsigned short UINT16;
typedef int boolean;

enum J_COLOR_SPACE { JCS_UNKNOWN, JCS_GRAYSCALE, JCS_RGB, JCS_YCbCr, JCS_CMYK, JCS_YCCK };
enum J_DCT_METHOD { JDCT_ISLOW, JDCT_IFAST, JDCT_FLOAT };
enum J_DITHER_MODE { JDITHER_NONE, JDITHER_ORDERED, JDITHER_FS };

constexpr int JPEG_LIB_VERSION = 62;
constexpr int DCTSIZE2 = 64;
constexpr int NUM_QUANT_TBLS = 4;
constexpr int NUM_HUFF_TBLS = 4;
constexpr int NUM_ARITH_TBLS = 16;
constexpr int MAX_COMPS_IN_SCAN = 4;
constexpr int D_MAX_BLOCKS_IN_MCU = 10;
constexpr int JMSG_STR_PARM_MAX = 80;
constexpr int JPEG_HEADER_OK = 1;
constexpr boolean TRUE = 1;
constexpr boolean FALSE = 0;

struct jpeg_error_mgr;
struct jpeg_memory_mgr;
struct jpeg_progress_mgr;

// The fields every libjpeg object begins with (jpeg_common_fields).
struct jpeg_common_struct {
  jpeg_error_mgr* err;
  jpeg_memory_mgr* mem;
  jpeg_progress_mgr* progress;
  void* client_data;
  boolean is_decompressor;
  int global_state;
};
typedef jpeg_common_struct* j_common_ptr;

struct jpeg_error_mgr {
  void (*error_exit)(j_common_ptr cinfo);
  void (*emit_message)(j_common_ptr cinfo, int msg_level);
  void (*output_message)(j_common_ptr cinfo);
  void (*format_message)(j_common_ptr cinfo, char* buffer);
  void (*reset_error_mgr)(j_common_ptr cinfo);
  int msg_code;
  union {
    int i[8];
    char s[JMSG_STR_PARM_MAX];
  } msg_parm;
  int trace_level;
  long num_warnings;
  const char* const* jpeg_message_table;
  int last_jpeg_message;
  const char* const* addon_message_table;
  int first_addon_message;
  int last_addon_message;
};

// Modules the application only passes around: opaque here.
struct jpeg_source_mgr;
struct jpeg_component_info;
struct JQUANT_TBL;
struct JHUFF_TBL;
struct jpeg_marker_struct;

struct jpeg_decompress_struct {
  // jpeg_common_fields
  jpeg_error_mgr* err;
  jpeg_memory_mgr* mem;
  jpeg_progress_mgr* progress;
  void* client_data;
  boolean is_decompressor;
  int global_state;

  jpeg_source_mgr* src;
  JDIMENSION image_width;
  JDIMENSION image_height;
  int num_components;
  J_COLOR_SPACE jpeg_color_space;
  J_COLOR_SPACE out_color_space;
  unsigned int scale_num, scale_denom;
  double output_gamma;
  boolean buffered_image;
  boolean raw_data_out;
  J_DCT_METHOD dct_method;
  boolean do_fancy_upsampling;
  boolean do_block_smoothing;
  boolean quantize_colors;
  J_DITHER_MODE dither_mode;
  boolean two_pass_quantize;
  int desired_number_of_colors;
  boolean enable_1pass_quant;
  boolean enable_external_quant;
  boolean enable_2pass_quant;
  JDIMENSION output_width;
  JDIMENSION output_height;
  int out_color_components;
  int output_components;
  int rec_outbuf_height;
  int actual_number_of_colors;
  JSAMPARRAY colormap;
  JDIMENSION output_scanline;
  int input_scan_number;
  JDIMENSION input_iMCU_row;
  int output_scan_number;
  JDIMENSION output_iMCU_row;
  int (*coef_bits)[DCTSIZE2];
  JQUANT_TBL* quant_tbl_ptrs[NUM_QUANT_TBLS];
  JHUFF_TBL* dc_huff_tbl_ptrs[NUM_HUFF_TBLS];
  JHUFF_TBL* ac_huff_tbl_ptrs[NUM_HUFF_TBLS];
  int data_precision;
  jpeg_component_info* comp_info;
  boolean progressive_mode;
  boolean arith_code;
  UINT8 arith_dc_L[NUM_ARITH_TBLS];
  UINT8 arith_dc_U[NUM_ARITH_TBLS];
  UINT8 arith_ac_K[NUM_ARITH_TBLS];
  unsigned int restart_interval;
  boolean saw_JFIF_marker;
  UINT8 JFIF_major_version;
  UINT8 JFIF_minor_version;
  UINT8 density_unit;
  UINT16 X_density;
  UINT16 Y_density;
  boolean saw_Adobe_marker;
  UINT8 Adobe_transform;
  boolean CCIR601_sampling;
  jpeg_marker_struct* marker_list;
  int max_h_samp_factor;
  int max_v_samp_factor;
  int min_DCT_scaled_size;
  JDIMENSION total_iMCU_rows;
  JSAMPLE* sample_range_limit;
  int comps_in_scan;
  jpeg_component_info* cur_comp_info[MAX_COMPS_IN_SCAN];
  JDIMENSION MCUs_per_row;
  JDIMENSION MCU_rows_in_scan;
  int blocks_in_MCU;
  int MCU_membership[D_MAX_BLOCKS_IN_MCU];
  int Ss, Se, Ah, Al;
  int unread_marker;
  // The decompressor's internal modules.
  void* master;
  void* main;
  void* coef;
  void* post;
  void* inputctl;
  void* marker;
  void* entropy;
  void* idct;
  void* upsample;
  void* cconvert;
  void* cquantize;
};
typedef jpeg_decompress_struct* j_decompress_ptr;

jpeg_error_mgr* jpeg_std_error(jpeg_error_mgr* err);
void jpeg_CreateDecompress(j_decompress_ptr cinfo, int version, size_t structsize);
void jpeg_destroy_decompress(j_decompress_ptr cinfo);
void jpeg_abort_decompress(j_decompress_ptr cinfo);
void jpeg_mem_src(j_decompress_ptr cinfo, const unsigned char* inbuffer, unsigned long insize);
int jpeg_read_header(j_decompress_ptr cinfo, boolean require_image);
boolean jpeg_start_decompress(j_decompress_ptr cinfo);
JDIMENSION jpeg_read_scanlines(j_decompress_ptr cinfo, JSAMPARRAY scanlines,
                               JDIMENSION max_lines);
boolean jpeg_finish_decompress(j_decompress_ptr cinfo);

}  // extern "C"

inline void jpeg_create_decompress(j_decompress_ptr cinfo) {
  jpeg_CreateDecompress(cinfo, JPEG_LIB_VERSION, sizeof(jpeg_decompress_struct));
}
