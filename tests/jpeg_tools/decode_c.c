/* Decodes a JPEG file with libjpeg and writes its rows to stdout, RGB or
 * grey, as Pillow asks for them; exits 1 on a libjpeg error.
 *
 *   decode_c IN
 *
 * As under Pillow, the data end where the file ends (no EOI is made up)
 * and nothing after the last row is read. Run with JSIMD_FORCENONE=1 it is
 * libjpeg-turbo's C code throughout: the reference for damaged data, where
 * the SIMD IDCT (exact only while the dequantized coefficients fit in 16
 * bits) and the C IDCT part. */
#include <setjmp.h>
#include <stdio.h>
#include <stdlib.h>
#include <jpeglib.h>

struct error_mgr {
    struct jpeg_error_mgr pub;
    jmp_buf jump;
};

static void error_exit(j_common_ptr cinfo) {
    longjmp(((struct error_mgr *)cinfo->err)->jump, 1);
}

static void emit_message(j_common_ptr cinfo, int level) {
    (void)cinfo;
    (void)level;
}

/* the whole file in memory; a read past its end is an error */
static void init_source(j_decompress_ptr cinfo) { (void)cinfo; }
static boolean fill_input_buffer(j_decompress_ptr cinfo) {
    (*cinfo->err->error_exit)((j_common_ptr)cinfo);
    return FALSE;
}
static void skip_input_data(j_decompress_ptr cinfo, long n) {
    struct jpeg_source_mgr *src = cinfo->src;
    if (n <= 0) return;
    if ((size_t)n > src->bytes_in_buffer)
        (*cinfo->err->error_exit)((j_common_ptr)cinfo);
    src->next_input_byte += n;
    src->bytes_in_buffer -= (size_t)n;
}
static void term_source(j_decompress_ptr cinfo) { (void)cinfo; }

int main(int argc, char **argv) {
    if (argc < 2) return 2;
    FILE *f = fopen(argv[1], "rb");
    if (!f) return 2;
    fseek(f, 0, SEEK_END);
    long size = ftell(f);
    fseek(f, 0, SEEK_SET);
    unsigned char *data = malloc(size > 0 ? (size_t)size : 1);
    if (!data || fread(data, 1, (size_t)size, f) != (size_t)size) return 2;
    fclose(f);
    struct jpeg_source_mgr mem = {data, (size_t)size, init_source,
                                  fill_input_buffer, skip_input_data,
                                  jpeg_resync_to_restart, term_source};
    struct jpeg_decompress_struct src;
    struct error_mgr err;
    src.err = jpeg_std_error(&err.pub);
    err.pub.error_exit = error_exit;
    err.pub.emit_message = emit_message;
    if (setjmp(err.jump)) return 1;
    jpeg_create_decompress(&src);
    src.src = &mem;
    jpeg_read_header(&src, TRUE);
    jpeg_start_decompress(&src);
    size_t stride = (size_t)src.output_width * src.output_components;
    unsigned char *row = malloc(stride);
    if (!row) return 2;
    while (src.output_scanline < src.output_height) {
        jpeg_read_scanlines(&src, &row, 1);
        fwrite(row, 1, stride, stdout);
    }
    jpeg_destroy_decompress(&src);
    free(row);
    free(data);
    return 0;
}
