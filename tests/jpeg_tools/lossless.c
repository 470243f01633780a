/* Writes an 8-bit PGM or PPM (P5/P6) as a lossless JPEG (SOF3):
 *
 *   lossless IN OUT PSV PT [rst ROWS]
 *
 *   PSV        the predictor, 1..7
 *   PT         the point transform, 0..7
 *   rst ROWS   a restart marker every ROWS MCU rows
 *
 * libjpeg-turbo 3.x writes lossless JPEG (jpeg_enable_lossless) and keeps
 * the samples as they are: grey, or RGB with an Adobe marker. Built
 * against a libjpeg-turbo 3.x shared library (Pillow bundles one):
 * cc lossless.c /path/libjpeg.so.62 -Wl,-rpath,/path. */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <jpeglib.h>

/* libjpeg-turbo 3.x; the 2.x headers do not declare it */
void jpeg_enable_lossless(j_compress_ptr cinfo, int predictor_selection_value,
                          int point_transform);

int main(int argc, char **argv) {
    if (argc < 5) {
        fprintf(stderr, "usage: lossless IN OUT PSV PT [rst ROWS]\n");
        return 2;
    }
    FILE *fi = fopen(argv[1], "rb");
    if (!fi) return 2;
    char magic[3] = {0};
    int w, h, maxval;
    if (fscanf(fi, "%2s %d %d %d", magic, &w, &h, &maxval) != 4 ||
        maxval != 255 || (magic[1] != '5' && magic[1] != '6'))
        return 2;
    fgetc(fi);
    int nc = magic[1] == '6' ? 3 : 1;
    size_t size = (size_t)w * h * nc;
    unsigned char *px = malloc(size);
    if (!px || fread(px, 1, size, fi) != size) return 2;
    fclose(fi);
    FILE *fo = fopen(argv[2], "wb");
    if (!fo) return 2;
    struct jpeg_compress_struct dst;
    struct jpeg_error_mgr err;
    dst.err = jpeg_std_error(&err);
    jpeg_create_compress(&dst);
    jpeg_stdio_dest(&dst, fo);
    dst.image_width = (JDIMENSION)w;
    dst.image_height = (JDIMENSION)h;
    dst.input_components = nc;
    dst.in_color_space = nc == 3 ? JCS_RGB : JCS_GRAYSCALE;
    jpeg_set_defaults(&dst);
    jpeg_enable_lossless(&dst, atoi(argv[3]), atoi(argv[4]));
    for (int i = 5; i < argc; ++i) {
        if (!strcmp(argv[i], "rst") && i + 1 < argc) {
            dst.restart_in_rows = atoi(argv[++i]);
        } else {
            fprintf(stderr, "lossless: bad argument %s\n", argv[i]);
            return 2;
        }
    }
    jpeg_start_compress(&dst, TRUE);
    while (dst.next_scanline < dst.image_height) {
        JSAMPROW row = px + (size_t)dst.next_scanline * w * nc;
        jpeg_write_scanlines(&dst, &row, 1);
    }
    jpeg_finish_compress(&dst);
    jpeg_destroy_compress(&dst);
    fclose(fo);
    free(px);
    return 0;
}
